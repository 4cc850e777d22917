"""host_enqueue_ms.decode: mean host time (ms) from a decode step's start
until ``LMServer.step`` returns, before the argmax's copy, over the
measured window's steps (the profiler off)."""

import numpy as np


def read(run):
    w = run["window"]
    if w["kind"] != "decode":
        return None
    return 1e3 * float(np.mean(w["spans"]["step"]))
