"""Wrapper of EmbeddingBag over padded bags (``csrc/embedding_bag.cu``).

For CUDA tensors it launches the hand-written kernel, or raises; for CPU
tensors it computes the plain version (:mod:`.ref`).  ``launches`` counts
kernel launches, and nothing else.
"""

import ctypes

import torch

from repro_torch.kernels import build

from .ref import embedding_bag_padded_ref

NAME = "embedding_bag"
DTYPES = (torch.float32, torch.bfloat16)
launches = 0


def _launcher():
    fn = build.load(NAME).embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(table, indices, weights):
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"table must be [V, D] and indices [B, L]; got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows (V = 0)")
    if weights.shape != indices.shape:
        raise ValueError(f"weights must have the indices' shape "
                         f"{tuple(indices.shape)}, got {tuple(weights.shape)}")
    cpu = table.device.type == "cpu"
    if table.dtype not in DTYPES + ((torch.float64,) if cpu else ()):
        raise TypeError(f"the table must be one of {DTYPES} (float64 too on "
                        f"the CPU), got {table.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    for name, x in (("indices", indices), ("weights", weights)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, the table on "
                             f"{table.device}")
    for name, x in (("table", table), ("indices", indices),
                    ("weights", weights)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted bags of rows: table [V, D] float32 or bfloat16; indices
    [B, L] int32 (padding carries weight 0); weights [B, L] float32 →
    [B, D] in the table's dtype, ``Σ_i weights[b, i] · table[indices[b,
    i]]`` added in bag order in float32.  Ids follow ``jnp.take``: [-V, 0)
    wraps, outside [-V, V) gives a NaN row (see :mod:`.ref`).  All three
    contiguous, on one device.  A table that is not 16-byte aligned, or
    whose rows are not a multiple of 16 bytes, takes scalar loads."""
    global launches
    _check(table, indices, weights)
    if table.device.type == "cpu":
        return embedding_bag_padded_ref(table, indices, weights)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    b, l = indices.shape
    v, d = table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    vec = int(table.data_ptr() % 16 == 0
              and (d * table.element_size()) % 16 == 0)
    launch = _launcher()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(table.data_ptr(), indices.data_ptr(),
                     weights.data_ptr(), out.data_ptr(), v, b, l, d,
                     int(table.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out
