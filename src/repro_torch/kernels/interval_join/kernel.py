"""Wrapper of the containment join (``csrc/interval_join.cu``).

For CUDA tensors it launches the hand-written kernel, or raises; for CPU
tensors it computes the plain version (:mod:`.ref`).  ``launches`` counts
kernel launches, and nothing else.
"""

import ctypes

import torch

from repro_torch.kernels import build

from .ref import MODES

NAME = "interval_join"
launches = 0


def _launcher():
    fn = build.load(NAME).interval_join_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def interval_join(a_s: torch.Tensor, a_e: torch.Tensor, b_s: torch.Tensor,
                  b_e: torch.Tensor, mode: str = "contained_in"
                  ) -> torch.Tensor:
    """Containment join over packed lists → int32 mask [NA].

    ``mode="contained_in"``: mask[i] = 1 iff some B[j] has
    b_s ≤ a_s ∧ a_e ≤ b_e; ``mode="containing"``: iff some B[j] has
    a_s ≤ b_s ∧ b_e ≤ a_e.  Entries whose start is PAD (int32 max) never
    match, on either side.

    Contract: B is a GC-list — its valid starts strictly increase, so do
    its valid ends, and its PAD entries form the tail (``pack`` of a
    G-reduced list, any containment operator's output, or a combination
    operator's output after ``core.vectorized.compact``).  A may be in any
    order.  All four tensors are 1-D int32 on one device.
    """
    global launches
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    for name, x, like in (("a_s", a_s, a_s), ("a_e", a_e, a_s),
                          ("b_s", b_s, b_s), ("b_e", b_e, b_s)):
        if x.dim() != 1 or x.shape != like.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}: starts and "
                             f"ends must be 1-D and of one length")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != a_s.device:
            raise ValueError(f"{name} is on {x.device}, a_s on {a_s.device}")
    if a_s.device.type == "cpu":
        return MODES[mode](a_s, a_e, b_s, b_e)
    if a_s.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_s.device}")
    for name, x in (("a_s", a_s), ("a_e", a_e), ("b_s", b_s), ("b_e", b_e)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    na, nb = a_s.shape[0], b_s.shape[0]
    out = torch.empty(na, dtype=torch.int32, device=a_s.device)
    if na == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(a_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(a_s.data_ptr(), a_e.data_ptr(), b_s.data_ptr(),
                     b_e.data_ptr(), out.data_ptr(), na, nb,
                     int(mode == "containing"), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
