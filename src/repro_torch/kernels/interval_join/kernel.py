"""Wrapper of the containment join (``csrc/interval_join.cu``).

For CUDA tensors it launches the hand-written kernel, or raises; for CPU
tensors it computes the plain version (:mod:`.ref`).  ``launches`` counts
kernel launches, and nothing else.

The launch plan is :func:`plan`, a function of the lengths and the
pointers' alignment alone: a tile of A a block, and a window budget — the
most entries of B a tile's window may hold and still be searched in shared
memory.  :func:`tile_paths` says, from the lists alone, which path each
tile takes under a plan.

The wrapper is the operator ``torch.ops.repro_torch.interval_join``
(``torch.library.custom_op``; it mutates ``counts``), with a fake
implementation (the mask's shape and type alone) and a FLOP formula of 0:
the join searches and compares integers, and does no floating-point
operation.
"""

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.vectorized import PAD
from repro_torch.kernels import build

from .ref import MODES

NAME = "interval_join"
THREADS = 256          # threads a block (kThreads)
TILE = THREADS * 8     # elements of A a block, 8 a thread (kTile)
BUDGET = 1024          # entries of B a window may hold to be staged
launches = 0


class Plan(NamedTuple):
    tile: int          # elements of A a block
    threads: int       # threads a block
    budget: int        # entries of B a window may hold to be staged
    vec: int           # 4: 16-byte loads of A and stores of the mask; or 1
    vec_b: int         # 4: windows of B copied in 16-byte pieces; or 1
    grid: int          # tiles, ceil(na / tile)
    direct: bool       # one tile: the first design's kernel alone


def plan(na: int, nb: int, aligned: bool, b_aligned: bool = True) -> Plan:
    """The launch of a join of ``na`` elements of A against ``nb`` of B;
    ``aligned``: A's starts and ends and the mask start on 16 bytes;
    ``b_aligned``: B's starts and ends do.  A block takes a tile of TILE
    elements; a window of at most BUDGET entries of B is staged in shared
    memory, so that 8 blocks of 256 threads fit a SM.  ``nb`` changes
    nothing: a window's size is known only on the card, from the keys.  A
    list of one tile takes the first design's kernel alone (``direct``): a
    launch-bound call that a window would not shorten."""
    grid = -(-na // TILE)
    return Plan(TILE, THREADS, BUDGET, 4 if aligned else 1,
                4 if b_aligned else 1, grid, grid == 1)


def tile_paths(a_s, a_e, b_s, b_e, mode: str, p: Plan) -> dict:
    """The path each tile of A takes under plan ``p``, from the lists
    alone (the kernel decides the same, and counts it): ``staged`` — the
    window B[lo .. min(hi, NB-1)], lo and hi the lower bounds of the tile's
    least and greatest probe key (a_e for contained_in, a_s for containing)
    other than PAD in B's, holds at most ``p.budget``
    entries and is searched in shared memory; ``device`` — a wider window,
    searched in device memory (by the first design's kernel, which the
    last block tail-launches over those tiles, or by the block itself in a
    grid of at most 132 tiles); ``none`` — no probe key other than PAD,
    or an empty B.  Under a ``direct`` plan the one tile counts as
    ``device``.
    Also ``windows``: every tile's window size (-1 where none)."""
    key, bkey = (a_e, b_e) if mode == "contained_in" else (a_s, b_s)
    na, nb = key.shape[0], bkey.shape[0]
    pad = p.grid * p.tile - na
    valid = torch.nn.functional.pad(key != int(PAD), (0, pad))
    key = torch.nn.functional.pad(key.long(), (0, pad)).view(p.grid, p.tile)
    valid = valid.view(p.grid, p.tile)
    big = 1 << 40
    kmin = torch.where(valid, key, big).amin(1)
    kmax = torch.where(valid, key, -big).amax(1)
    some = valid.any(1) & (nb > 0)
    bkey = bkey.long().contiguous()
    lo = torch.searchsorted(bkey, kmin)
    hi = torch.searchsorted(bkey, kmax)
    w = torch.where(some, torch.clamp(hi, max=nb - 1) - lo + 1, -1)
    if p.direct:
        return {"staged": 0, "device": p.grid, "none": 0, "windows": w}
    staged = some & (w <= p.budget)
    return {"staged": int(staged.sum()), "device": int((some & ~staged).sum()),
            "none": int((~some).sum()), "windows": w}


_ctrls = {}


def _ctrl(device, stream: int) -> torch.Tensor:
    """The launch's counter for ``stream`` (blocks done, tiles listed):
    zero at first, and zero again after every launch (the kernel's last
    block resets it), so launches in one stream share it and launches in
    two never do."""
    key = (device.index, stream)
    ctrl = _ctrls.get(key)
    if ctrl is None:
        ctrl = _ctrls.setdefault(
            key, torch.zeros(1, dtype=torch.int64, device=device))
    return ctrl


def _launcher():
    fn = build.load(NAME).interval_join_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


def _check(a_s, a_e, b_s, b_e, mode):
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


def interval_join(a_s: torch.Tensor, a_e: torch.Tensor, b_s: torch.Tensor,
                  b_e: torch.Tensor, mode: str = "contained_in",
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
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

    On the card, ``counts`` (int32 [3] on the same device, or None) gains
    the kernel's tiles by path: staged, device memory, nothing to search
    (see :func:`tile_paths`).
    """
    return interval_join_op(a_s, a_e, b_s, b_e, mode, counts)


# the operator's argument is ``join_mode``: an argument named ``mode``
# collides with the dispatcher's own in AOT tracing
@torch.library.custom_op("repro_torch::interval_join",
                         mutates_args=("counts",))
def interval_join_op(a_s: torch.Tensor, a_e: torch.Tensor, b_s: torch.Tensor,
                     b_e: torch.Tensor, join_mode: str,
                     counts: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`interval_join` as an operator (eager implementation)."""
    global launches
    mode = join_mode
    _check(a_s, a_e, b_s, b_e, mode)
    if a_s.device.type == "cpu":
        if counts is not None:
            raise ValueError("counts are the kernel's: the CPU path has none")
        return MODES[mode](a_s, a_e, b_s, b_e)
    if a_s.device.type != "cuda":
        raise ValueError(f"no kernel for device {a_s.device}")
    for name, x in (("a_s", a_s), ("a_e", a_e), ("b_s", b_s), ("b_e", b_e)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if counts is not None and (counts.shape != (3,) or counts.dtype !=
                               torch.int32 or counts.device != a_s.device):
        raise ValueError("counts must be int32 [3] on the lists' device")
    na, nb = a_s.shape[0], b_s.shape[0]
    out = torch.empty(na, dtype=torch.int32, device=a_s.device)
    if na == 0:
        return out
    p = plan(na, nb, (a_s.data_ptr() | a_e.data_ptr() | out.data_ptr())
             % 16 == 0, (b_s.data_ptr() | b_e.data_ptr()) % 16 == 0)
    launch = _launcher()
    with torch.cuda.device(a_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        ctrl = wide = None              # the tiles kernel's list and counter
        if not p.direct:
            ctrl = _ctrl(a_s.device, stream).data_ptr()
            wide = torch.empty(p.grid, dtype=torch.int32, device=a_s.device)
        err = launch(a_s.data_ptr(), a_e.data_ptr(), b_s.data_ptr(),
                     b_e.data_ptr(), out.data_ptr(), na, nb,
                     int(mode == "containing"), p.tile, p.threads, p.budget,
                     int(p.vec == 4), int(p.vec_b == 4), p.grid,
                     int(p.direct), ctrl,
                     None if wide is None else wide.data_ptr(),
                     None if counts is None else counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    if counts is not None and p.direct:     # the one tile, by the first
        counts[1] += 1                      # design's kernel
    launches += 1
    return out


@interval_join_op.register_fake
def _interval_join_fake(a_s, a_e, b_s, b_e, join_mode, counts):
    _check(a_s, a_e, b_s, b_e, join_mode)
    return torch.empty_like(a_s)


@register_flop_formula(torch.ops.repro_torch.interval_join)
def _interval_join_flops(*args, **kwargs) -> int:
    return 0
