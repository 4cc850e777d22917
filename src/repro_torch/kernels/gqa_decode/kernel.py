"""Wrapper of flash-decoding GQA attention (``csrc/gqa_decode.cu``).

For CUDA tensors it launches the hand-written split-KV kernel, or raises;
for CPU tensors it computes the plain version (:mod:`.ref`).  ``launches``
counts wrapper calls that launched the kernel (its partial and combine
passes count as one), and nothing else.

The kernel has two partial passes, chosen by :func:`path` from the dtype
and D alone: ``MMA`` (bfloat16, D ≤ 128: K/V tiles through a shared-memory
ring fed by ``cp.async`` copies, both products on tensor cores) and ``FMA``
(float32, and bfloat16 with D > 128: float32 FMAs).  A build or launch
that fails raises; no path falls back to another.
"""

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

from .ref import gqa_decode_ref

NAME = "gqa_decode"
MMA, FMA = "mma", "fma"
MMA_MAX_D = 128
TILE = 128             # positions per tile of the mma kernel, as built
STAGES = 2             # its ring's stages, as built (GQA_TILE, GQA_STAGES)
BLOCKS_PER_SM = 1      # mma blocks the split count aims at, per SM
                       # (swept by launch.decode_sweep)
FMA_BLOCKS_PER_SM = 8  # the same for the fma kernel
MIN_SPLIT = 256        # fewest positions a split walks
MAX_G = 8
MAX_D = 256
SMEM_LIMIT = 232_448   # shared memory a block may use on Hopper (227 KB)
DTYPES = (torch.float32, torch.bfloat16)
launches = 0

_sm_count = {}


def _launcher():
    """(launch function, the library's mma tile): the tile as built, so a
    library built with another ``GQA_TILE`` gets splits to match."""
    lib = build.load(NAME)
    fn = lib.gqa_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn, lib.gqa_decode_tile()


def path(dtype: torch.dtype, d: int) -> str:
    """The partial pass for q's dtype and head width D: tensor cores for
    bfloat16 up to D = 128, float32 FMAs otherwise (TF32 would miss the
    float32 tolerance; at D = 256 the mma accumulator alone would take 128
    registers)."""
    return MMA if dtype == torch.bfloat16 and d <= MMA_MAX_D else FMA


def mma_smem_bytes(d: int, tile: int = None, stages: int = None) -> int:
    """Shared memory of one mma block: the ring's dynamic part (STAGES
    stages of a K and a V tile, TILE rows of D rounded up to 16 plus 8
    bfloat16 each; ``mma_smem_bytes`` in the source) and the static part
    (a barrier a stage, the warps' m and l of 8 rows)."""
    tile, stages = tile or TILE, stages or STAGES
    dp = -(-d // 16) * 16
    return (stages * 2 * tile * (dp + 8) * 2 + 8 * stages
            + 2 * (tile // 16) * 8 * 4)


def splits(bh: int, s: int, sms: int, kind: str = MMA, tile: int = None):
    """(n_split, chunk): the KV axis cut into ``n_split`` runs of ``chunk``
    positions.  Depends on shapes only, never on ``length``; every split
    holds a position and, when there are several, at least ``MIN_SPLIT``.

    ``MMA``: about ``BLOCKS_PER_SM`` blocks per SM, rounded down so that
    ``bh·n_split`` blocks fit the card in one wave, and ``chunk`` a
    multiple of the tile.  ``FMA``: at least ``FMA_BLOCKS_PER_SM`` blocks
    per SM (rounded up)."""
    if kind == MMA:
        unit = tile or TILE
        n = BLOCKS_PER_SM * sms // bh
    else:
        unit = 1
        n = -(-FMA_BLOCKS_PER_SM * sms // bh)
    n = max(1, min(n, s // MIN_SPLIT))
    per = -(-s // n)
    chunk = -(-per // unit) * unit
    return -(-s // chunk), chunk


def _check(q, k, v, length):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, Hkv, G, D] and k, v [B, S, Hkv, D]; "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, hkv, g, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, S, Hkv, D] = [{b}, S, {hkv}, "
                         f"{d}]; got {tuple(k.shape)} and {tuple(v.shape)}")
    if length.shape != (b,):
        raise ValueError(f"length must be [B] = [{b}], got "
                         f"{tuple(length.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, got {length.dtype}")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"D must be a multiple of 8 up to {MAX_D}, got {d}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"G must be 1 to {MAX_G}, got {g}")
    if s == 0:
        raise ValueError("the cache has no positions (S = 0)")
    for name, x in (("q", q), ("k", k), ("v", v), ("length", length)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """Attention of one query token per sequence against its KV cache.

    q [B, Hkv, G, D]; k, v [B, S, Hkv, D]; length [B] int32 →
    [B, Hkv, G, D] in q's dtype.  q, k and v are float32 or bfloat16 (one
    type), contiguous; D is a multiple of 8 up to 256; G is 1 to 8.
    Positions at or past ``length[b]`` do not count, a ``length`` above S
    means all S positions, and ``length == 0`` gives zeros (the Pallas
    kernel's semantics, see :mod:`.ref`).
    """
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return gqa_decode_ref(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return _launch(q, k, v, length, path(q.dtype, q.shape[-1]))


def _launch(q, k, v, length, kind: str) -> torch.Tensor:
    """Launch the partial pass ``kind`` and the combine on checked CUDA
    tensors, and count the launch."""
    global launches
    b, hkv, g, d = q.shape
    s = k.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    launch, tile = _launcher()
    n_split, chunk = splits(b * hkv, s, sms, kind, tile)
    part = torch.empty(b * hkv * n_split * g * (d + 2), dtype=torch.float32,
                       device=q.device)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))   # as ref.py
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     length.data_ptr(), out.data_ptr(), part.data_ptr(),
                     b, s, hkv, g, d, n_split, chunk, scale,
                     int(q.dtype == torch.bfloat16), int(kind == MMA),
                     stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
