"""decode_tokens_per_s: tokens served by all slots over the measured
window's wall time (slots x completed steps / seconds)."""


def read(run):
    w = run["window"]
    if w["kind"] != "decode":
        return None
    return w["slots"] * w["steps"] / w["seconds"]
