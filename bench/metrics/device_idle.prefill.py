"""device_idle.prefill: share (%) of the traced sub-window in which no
kernel or copy ran on the device, from the profiler's timeline."""


def read(run):
    tr = run["trace"]
    if tr is None or run["kind"] != "prefill":
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
