"""Wrappers of EmbeddingBag over padded bags (``csrc/embedding_bag.cu``)
and of its backward with respect to the table
(``csrc/embedding_bag_backward.cu``).

For CUDA tensors each launches its hand-written kernel, or raises; for CPU
tensors it computes the plain version (:mod:`.ref`).  ``launches`` and
``backward_launches`` count kernel launches, and nothing else.

The launch plans are :func:`plan` and :func:`backward_plan`, functions of
the shapes, the alignment and the card's SM count alone.
"""

import ctypes
from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

from .ref import embedding_bag_backward_ref, embedding_bag_padded_ref

NAME = "embedding_bag"
BACKWARD = "embedding_bag_backward"
DTYPES = (torch.float32, torch.bfloat16)
WARPS = 8              # warps a block (kWarps)
ROWS = 4               # rows a group of lanes has in flight (kRows)
WARP_ROWS = 2          # rows a warp has in flight, a bag a warp (kWarpRows)
WARPS_PER_SM = 64      # warps the runs of bags are cut for, per SM (two
                       # waves or more at the grouped kernel's occupancy)
BACKWARD_BLOCKS_PER_SM = 8   # the backward's grid cap (grid-stride walk)
launches = 0
backward_launches = 0


class Plan(NamedTuple):
    vec: int           # elements a load: 16 bytes' worth, or 1
    lanes: int         # lanes a bag (a power of two); 32: a warp a bag
    ch: int            # vectors a lane a pass (1, or 2 at 32 lanes)
    bags: int          # bags a group takes a step (1 at 32 lanes)
    items: int         # rows of each bag in flight a step
    bags_per_warp: int  # the run of consecutive bags a warp takes
    grid: int          # blocks of WARPS warps
    passes: int        # passes over D of ch · lanes · vec elements


def plan(b: int, l: int, d: int, elt: int, aligned: bool, sms: int) -> Plan:
    """The launch of B bags of L items over rows of D elements of ``elt``
    bytes on a card of ``sms`` SMs; ``aligned``: the table starts on 16
    bytes.  Rows a multiple of 16 bytes on an aligned table take 16-byte
    loads.  A row of more than 16 vectors takes the warp kernel: a warp a
    bag, one or two vectors a lane (wider rows in passes), WARP_ROWS rows
    in flight.  A narrower row takes the grouped kernel: the fewest
    lanes (a power of two, at most 16) that hold it, one bag a group, the
    most bags (a power of two) whose L items fit the group's ROWS rows in
    flight, else one bag in steps of ROWS items, and runs cut for
    WARPS_PER_SM warps a SM, a whole number of steps each."""
    vec = 16 // elt if aligned and (d * elt) % 16 == 0 else 1
    vectors = -(-d // vec)
    if vectors > 16:
        ch = 1 if vectors <= 32 else 2
        return Plan(vec, 32, ch, 1, WARP_ROWS, 1, max(1, -(-b // WARPS)),
                    -(-vectors // (32 * ch)))
    lanes = 1 << max(vectors - 1, 0).bit_length()
    bags = 1 << max(ROWS // max(l, 1), 1).bit_length() - 1
    step = 32 // lanes * bags
    per_warp = -(-b // (sms * WARPS_PER_SM))
    per_warp = max(1, -(-per_warp // step)) * step
    warps = -(-b // per_warp)
    return Plan(vec, lanes, 1, bags, ROWS // bags, per_warp,
                max(1, -(-warps // WARPS)), 1)


def _launcher():
    fn = build.load(NAME).embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(table, indices, weights, what: str = "table"):
    """The checks both wrappers make; ``table`` is the table, or for the
    backward grad_out ([B, D], the table's type), named by ``what``."""
    if table.dim() != 2 or indices.dim() != 2:
        form = "[V, D]" if what == "table" else "[B, D]"
        raise ValueError(f"{what} must be {form} and indices [B, L]; got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if weights.shape != indices.shape:
        raise ValueError(f"weights must have the indices' shape "
                         f"{tuple(indices.shape)}, got {tuple(weights.shape)}")
    cpu = table.device.type == "cpu"
    if table.dtype not in DTYPES + ((torch.float64,) if cpu else ()):
        raise TypeError(f"the {what} must be one of {DTYPES} (float64 too "
                        f"on the CPU), got {table.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    for name, x in (("indices", indices), ("weights", weights)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, the {what} on "
                             f"{table.device}")
    for name, x in ((what, table), ("indices", indices),
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
    if table.shape[0] == 0:
        raise ValueError("the table has no rows (V = 0)")
    if table.device.type == "cpu":
        return embedding_bag_padded_ref(table, indices, weights)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    b, l = indices.shape
    v, d = table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    p = plan(b, l, d, table.element_size(), table.data_ptr() % 16 == 0,
             sm_count(table.device))
    launch = _launcher()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(table.data_ptr(), indices.data_ptr(),
                     weights.data_ptr(), out.data_ptr(), v, b, l, d,
                     int(table.dtype == torch.bfloat16), int(p.vec > 1),
                     p.lanes.bit_length() - 1, p.ch, p.bags,
                     p.bags_per_warp, p.grid, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    launches += 1
    return out


class BackwardPlan(NamedTuple):
    vec: int           # elements a load of grad_out: 16 bytes' worth, or 1
    lanes: int         # lanes an item (a power of two, at most 32)
    grid: int          # blocks of WARPS warps


def backward_plan(n_items: int, d: int, elt: int, aligned: bool,
                  sms: int) -> BackwardPlan:
    """The backward's launch over ``n_items`` = B · L items and rows of D
    elements of ``elt`` bytes (grad_out's type) on a card of ``sms`` SMs;
    ``aligned``: grad_out starts on 16 bytes.  A row a multiple of 16
    bytes takes 16-byte loads.  An item takes the fewest lanes (a power of
    two, at most 32) that hold its row's vectors, 32 / lanes items a warp
    at once; the grid covers every item once, at most
    BACKWARD_BLOCKS_PER_SM blocks a SM, which walk the rest."""
    vec = 16 // elt if aligned and (d * elt) % 16 == 0 else 1
    vectors = -(-d // vec)
    lanes = min(32, 1 << max(vectors - 1, 0).bit_length())
    warps = -(-n_items // (32 // lanes))
    grid = max(1, min(-(-warps // WARPS), sms * BACKWARD_BLOCKS_PER_SM))
    return BackwardPlan(vec, lanes, grid)


def _backward_launcher():
    fn = build.load(BACKWARD).embedding_bag_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """The gradient [num_rows, D] of :func:`embedding_bag` with respect to
    a table of ``num_rows`` rows: ``grad[indices[b, i]] += weights[b, i] ·
    grad_out[b]``, accumulated in float32 and cast once to grad_out's type,
    which is the table's (float32 or bfloat16; float64 too on the CPU);
    indices [B, L] int32 and weights
    [B, L] float32, all contiguous on one device.  Ids in [-V, 0) wrap,
    ids outside [-V, V) and items of weight 0 add nothing.  On the card
    the rows are added with atomics, in an order that changes from run to
    run (see ``csrc/embedding_bag_backward.cu`` for the tolerance)."""
    global backward_launches
    _check(grad_out, indices, weights, "grad_out")
    if grad_out.shape[0] != indices.shape[0]:
        raise ValueError(f"grad_out has {grad_out.shape[0]} bags, indices "
                         f"{indices.shape[0]}")
    if num_rows <= 0:
        raise ValueError("the table has no rows (V = 0)")
    dtype = grad_out.dtype
    if grad_out.device.type == "cpu":
        return embedding_bag_backward_ref(grad_out, indices, weights,
                                          num_rows).to(dtype)
    if grad_out.device.type != "cuda":
        raise ValueError(f"no kernel for device {grad_out.device}")
    b, l = indices.shape
    d = grad_out.shape[1]
    grad = torch.zeros((num_rows, d), dtype=torch.float32,
                       device=grad_out.device)
    if b == 0 or l == 0 or d == 0:
        return grad.to(dtype)
    p = backward_plan(b * l, d, grad_out.element_size(),
                      grad_out.data_ptr() % 16 == 0, sm_count(grad_out.device))
    launch = _backward_launcher()
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(grad_out.data_ptr(), indices.data_ptr(),
                     weights.data_ptr(), grad.data_ptr(), num_rows, b, l, d,
                     int(dtype == torch.bfloat16), int(p.vec > 1),
                     p.lanes.bit_length() - 1, p.grid, stream)
    if err != 0:
        raise RuntimeError(f"{BACKWARD} kernel launch failed: CUDA error "
                           f"{err}")
    backward_launches += 1
    return grad.to(dtype)
