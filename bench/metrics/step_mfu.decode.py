"""step_mfu.decode: the step's least time on the chip over its measured
mean time, in %: for each step of the measured window the larger of its
model FLOPs over the dtype's peak and its bytes over the memory's rate
(``roofline.counts``), summed, over the window's seconds."""

from roofline import counts


def read(run):
    w = run["window"]
    if w["kind"] != "decode":
        return None
    s = run["shape"]
    bound = sum(counts.step_bound_s(s, counts.decode_step_flops(s, a),
                                    counts.decode_step_bytes(s, a))
                for a in w["attend"])
    return 100.0 * bound / w["seconds"]
