"""step_mfu.prefill: a call's least time on the chip (its model FLOPs
over the dtype's peak, ``roofline.counts.prefill_flops``) over the
measured window's mean time a call, in %."""

from roofline import counts


def read(run):
    w = run["window"]
    if w["kind"] != "prefill":
        return None
    s = run["shape"]
    flops = counts.prefill_flops(s, w["batch"], w["prompt_tokens"])
    return 100.0 * w["calls"] * flops / counts.peak_flops(s.dtype) \
        / w["seconds"]
