"""The reduction of a profiler timeline to the traced window's numbers:
busy time, idle gaps labelled by the host's runtime call, and a long
timeline (a full-depth 32k prefill holds tens of thousands of kernels)
reduced in a few seconds."""

from __future__ import annotations

import time
from types import SimpleNamespace as NS

import torch

from harness.trace import reduce_events

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, a, b, dev):
    return NS(name=name, device_type=dev,
              time_range=NS(start=a, end=b))


def test_gaps_are_labelled_by_the_call_the_host_was_in():
    events = [_ev("k1", 0, 10, CUDA), _ev("k2", 20, 30, CUDA),
              _ev("k3", 50, 60, CUDA), _ev("cudaLaunchKernel", 12, 18, CPU),
              _ev("cudaMemcpyAsync", 30, 45, CPU)]
    out = reduce_events(events)
    assert out["window_s"] == 60e-6 and out["busy_s"] == 30e-6
    idle = dict(out["idle_gaps"])
    assert idle == {"cudaLaunchKernel": 10e-6, "cudaMemcpyAsync": 20e-6}


def test_a_long_timeline_reduces_quickly():
    n = 100_000
    events = []
    for i in range(n):
        events.append(_ev("k", 10 * i, 10 * i + 6, CUDA))
        events.append(_ev("cudaLaunchKernel", 10 * i + 6, 10 * i + 9, CPU))
    t = time.perf_counter()
    out = reduce_events(events)
    assert time.perf_counter() - t < 10
    assert abs(dict(out["idle_gaps"])["cudaLaunchKernel"] - n * 4e-6) < 1e-6
