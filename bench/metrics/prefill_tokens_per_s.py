"""prefill_tokens_per_s: prompt tokens of all completed calls over the
measured window's wall time; a call ends with its prompts' first answer
tokens on the host."""


def read(run):
    w = run["window"]
    if w["kind"] != "prefill":
        return None
    return w["calls"] * w["batch"] * w["prompt_tokens"] / w["seconds"]
