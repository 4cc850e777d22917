"""gqa_decode_roofline.decode: a launch's bytes (``roofline.counts``,
q, the K and V rows up to each sequence's attend, the output) over the
memory's rate, over its device time in the traced sub-window, in %.
The device time is the mean of the partial pass's events plus the mean
of the combine's, each over the events the trace holds (the profiler can
drop some); the bytes are the mean over the traced steps."""

import numpy as np

from roofline import counts

PARTS = ("gqa_mma_partial_kernel", "gqa_partial_kernel",
         "gqa_combine_kernel")


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "decode":
        return None
    part, comb = [], []
    for name, durs in tr["kernels"].items():
        if PARTS[2] in name:
            comb += durs
        elif PARTS[0] in name or PARTS[1] in name:
            part += durs
    if not part or not comb:
        return None
    s = run["shape"]
    nbytes = np.mean([counts.gqa_decode_bytes(s, a) for a in tr["attend"]])
    return 100.0 * nbytes / counts.bandwidth() / (np.mean(part)
                                                  + np.mean(comb))
