"""decode_step_p95_ms: the 95th percentile, over every step of the
measured window, of the gap between one step's tokens reaching the host
and the next step's (the first gap from the window's start)."""

import numpy as np


def read(run):
    w = run["window"]
    if w["kind"] != "decode":
        return None
    return 1e3 * float(np.percentile(w["gaps"], 95))
