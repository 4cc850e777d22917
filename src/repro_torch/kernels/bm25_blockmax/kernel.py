"""Wrapper of the block-max pruned BM25 sweep (``csrc/bm25_blockmax.cu``).

For CUDA tensors it launches the hand-written kernel, or raises; for CPU
tensors it computes the plain version (:func:`.ref.blockmax_scores`).
``launches`` counts kernel launches, and nothing else.

The launch plan is :func:`plan`, a function of the shapes and the
pointers' alignment alone: a warp a doc block, ``WARPS`` warps a block.

The wrapper is the operator ``torch.ops.repro_torch.blockmax_scores``
(``torch.library.custom_op``), with a fake implementation (the output's
shape and type alone) and a FLOP formula: the function's additions, the
term sum of every document (T·NB·BS) and of every block's upper bound
(T·NB), pruned or not (which blocks are pruned is data).
"""

import ctypes
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

from .ref import blockmax_scores as blockmax_scores_plain

NAME = "bm25_blockmax"
WARPS = 8              # warps a block (kWarps)
MAX_TERMS = 16         # T up to here is a template parameter (kMaxTerms)
launches = 0


class Plan(NamedTuple):
    vec: int           # documents a lane loads at once: 4 (16 bytes) or 1
    terms: int         # the kernel's compiled T, 0 for the run-time loop
    grid: int          # blocks of WARPS warps, a doc block a warp
    passes: int        # passes of 32 · vec documents over a doc block


def plan(t: int, nb: int, bs: int, aligned: bool) -> Plan:
    """The launch of a [T, NB, BS] sweep; ``aligned``: impacts and the
    output start on 16 bytes."""
    vec = 4 if aligned and bs % 4 == 0 else 1
    return Plan(vec, t if 1 <= t <= MAX_TERMS else 0, -(-nb // WARPS),
                -(-bs // (32 * vec)))


def _launcher():
    fn = build.load(NAME).bm25_blockmax_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(impacts, block_max, theta):
    if impacts.dim() != 3 or block_max.shape != impacts.shape[:2]:
        raise ValueError(f"impacts {tuple(impacts.shape)} and block_max "
                         f"{tuple(block_max.shape)} are not [T, NB, BS] and "
                         f"[T, NB]")
    if theta.numel() != 1:
        raise ValueError(f"theta must hold one value, got {theta.numel()}")
    for name, x in (("impacts", impacts), ("block_max", block_max),
                    ("theta", theta)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != impacts.device:
            raise ValueError(f"{name} is on {x.device}, impacts on "
                             f"{impacts.device}")


@torch.library.custom_op("repro_torch::blockmax_scores", mutates_args=())
def blockmax_scores(impacts: torch.Tensor, block_max: torch.Tensor,
                    theta: torch.Tensor) -> torch.Tensor:
    """impacts [T, NB, BS] f32, block_max [T, NB] f32, theta [1] f32 →
    scores [NB, BS] f32, -inf on the blocks whose upper bound is below
    theta.  All three on one device; theta stays there.  Impacts off 16
    bytes, or BS not a multiple of 4, take scalar loads."""
    global launches
    _check(impacts, block_max, theta)
    if impacts.device.type == "cpu":
        return blockmax_scores_plain(impacts, block_max, theta)
    if impacts.device.type != "cuda":
        raise ValueError(f"no kernel for device {impacts.device}")
    for name, x in (("impacts", impacts), ("block_max", block_max),
                    ("theta", theta)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t, nb, bs = impacts.shape
    out = torch.empty((nb, bs), dtype=torch.float32, device=impacts.device)
    if out.numel() == 0:
        return out
    launch = _launcher()
    p = plan(t, nb, bs, (impacts.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(impacts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(impacts.data_ptr(), block_max.data_ptr(),
                     theta.data_ptr(), out.data_ptr(), t, nb, bs,
                     int(p.vec == 4), p.grid, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out


@blockmax_scores.register_fake
def _blockmax_scores_fake(impacts, block_max, theta):
    _check(impacts, block_max, theta)
    return impacts.new_empty(impacts.shape[1:])


@register_flop_formula(torch.ops.repro_torch.blockmax_scores)
def _blockmax_scores_flops(impacts_shape, *args, **kwargs) -> int:
    t, nb, bs = impacts_shape
    return t * nb * bs + t * nb
