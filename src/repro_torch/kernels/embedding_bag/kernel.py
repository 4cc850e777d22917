"""Wrappers of EmbeddingBag over padded bags (``csrc/embedding_bag.cu``)
and of its backward with respect to the table
(``csrc/embedding_bag_backward.cu``).

For CUDA tensors each launches its hand-written kernel, or raises; for CPU
tensors it computes the plain version (:mod:`.ref`).  ``launches`` and
``backward_launches`` count kernel launches, and nothing else.

The launch plans are :func:`plan` and :func:`backward_plan`, functions of
the shapes, the alignment and the card's SM count alone.  A backward call
is one host call that launches all of its kernels (``backward_launches``
counts it once).

Each wrapper is an operator (``torch.library.custom_op``):
``torch.ops.repro_torch.embedding_bag``, whose gradient with respect to the
table is ``torch.ops.repro_torch.embedding_bag_backward``
(``register_autograd``), each with a fake implementation (the output's
shape and type alone) and a FLOP formula of 2·B·L·D, a product and a sum
for every item and element, whatever the ids or weights.
"""

import ctypes
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import sm_count
from repro_torch.kernels import build

from .ref import PIECE, embedding_bag_backward_ref, embedding_bag_padded_ref

NAME = "embedding_bag"
BACKWARD = "embedding_bag_backward"
DTYPES = (torch.float32, torch.bfloat16)
WARPS = 8              # warps a block (kWarps)
ROWS = 4               # rows a group of lanes has in flight (kRows)
WARP_ROWS = 2          # rows a warp has in flight, a bag a warp (kWarpRows)
WARPS_PER_SM = 64      # warps the runs of bags are cut for, per SM (two
                       # waves or more at the grouped kernel's occupancy)
BACKWARD_BLOCKS_PER_SM = 8   # the backward's walks' grid cap
SORT_BLOCKS_PER_SM = 2       # the backward's sort: blocks a SM, a chunk each
SORT_BITS = 8                # bits a sort pass (kRadixBits)
SORT_RADIX = 1 << SORT_BITS
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


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=())
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
    lanes: int         # lanes a piece (a power of two, at most 32)
    keys_grid: int     # blocks of the keys kernel (a grid-stride walk)
    sort_grid: int     # blocks of the sort's and the runs' kernels
    passes: int        # sort passes of SORT_BITS over the bits of V - 1
    reduce_grid: int   # blocks of the reduction (a grid-stride walk)
    combine_grid: int  # the combine's blocks in y, over the long runs (x:
                       # ⌈vectors / WARPS⌉, a warp a vector of the row)
    workspace: int     # 4-byte words of scratch the launch needs


def _up64(words: int) -> int:
    return -(-words // 64) * 64


def backward_workspace(n_items: int, sort_grid: int, d: int) -> int:
    """The launch's scratch in 4-byte words, each part on 256 bytes (the
    layout of ``embedding_bag_backward.cu``'s ``layout``): the sort's
    double buffers of (row, item), its digit counts, the device counts,
    the runs (start and length), the long runs (start, length, first
    scratch row) and the later pieces' partials, at most ⌈n / PIECE⌉
    rows of D floats (a run of n > PIECE items has ⌈n / PIECE⌉ − 1 later
    pieces)."""
    n = n_items
    longs = n // (PIECE + 1) + 1
    parts = [n] * 4 + [sort_grid * SORT_RADIX, SORT_RADIX, 4,
                       3 * sort_grid, n, n, longs, longs, longs,
                       -(-n // PIECE) * d]
    return sum(_up64(w) for w in parts)


def backward_plan(n_items: int, v: int, d: int, elt: int, aligned: bool,
                  sms: int) -> BackwardPlan:
    """The backward's launch over ``n_items`` = B · L items into a table of
    ``v`` rows of D elements of ``elt`` bytes (grad_out's type) on a card
    of ``sms`` SMs; ``aligned``: grad_out starts on 16 bytes.  A row a
    multiple of 16 bytes takes 16-byte loads.  A piece takes the fewest
    lanes (a power of two, at most 32) that hold its row's vectors; the
    combine a warp a vector of a long run's row.  The sort runs
    SORT_BLOCKS_PER_SM blocks a SM, each a contiguous chunk of the items,
    in ⌈bits(V − 1) / SORT_BITS⌉ passes (at least one: the first compacts
    the dropped items out).  The walks are sized from the bound B · L
    (every item its own run) and capped at BACKWARD_BLOCKS_PER_SM blocks
    a SM; the counts they walk stay on the card."""
    vec = 16 // elt if aligned and (d * elt) % 16 == 0 else 1
    vectors = -(-d // vec)
    lanes = min(32, 1 << max(vectors - 1, 0).bit_length())
    cap = sms * BACKWARD_BLOCKS_PER_SM

    def grid(groups: int, per_block: int) -> int:
        return max(1, min(-(-groups // per_block), cap))
    sort_grid = sms * SORT_BLOCKS_PER_SM
    passes = max(1, -(-max(v - 1, 0).bit_length() // SORT_BITS))
    per_block = WARPS * (32 // lanes)
    return BackwardPlan(
        vec, lanes, grid(n_items, 32 * WARPS), sort_grid, passes,
        grid(n_items + -(-n_items // PIECE), per_block),
        max(1, min(n_items // (PIECE + 1) + 1,
                   cap // -(-vectors // WARPS))),
        backward_workspace(n_items, sort_grid, d))


def _backward_launcher():
    fn = build.load(BACKWARD).embedding_bag_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@embedding_bag.register_fake
def _embedding_bag_fake(table, indices, weights):
    _check(table, indices, weights)
    return table.new_empty((indices.shape[0], table.shape[1]))


def _check_backward(grad_out, indices, weights, num_rows):
    """The backward's checks beyond :func:`_check`'s."""
    _check(grad_out, indices, weights, "grad_out")
    if grad_out.shape[0] != indices.shape[0]:
        raise ValueError(f"grad_out has {grad_out.shape[0]} bags, indices "
                         f"{indices.shape[0]}")
    if num_rows <= 0:
        raise ValueError("the table has no rows (V = 0)")
    if num_rows >= 1 << 32:
        raise ValueError(f"{num_rows} rows: the kernel's rows are 32-bit "
                         f"keys (at most 2^32 - 1 rows)")
    if indices.numel() >= 1 << 31:
        raise ValueError(f"{indices.numel()} items: the kernel indexes "
                         f"items with int32 (B · L < 2^31)")


@torch.library.custom_op("repro_torch::embedding_bag_backward",
                         mutates_args=())
def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """The gradient [num_rows, D] of :func:`embedding_bag` with respect to
    a table of ``num_rows`` rows: ``grad[indices[b, i]] += weights[b, i] ·
    grad_out[b]``, accumulated in float32 and cast once to grad_out's type,
    which is the table's (float32 or bfloat16; float64 too on the CPU);
    indices [B, L] int32 and weights [B, L] float32, all contiguous on one
    device.  Ids in [-V, 0) wrap; ids outside [-V, V) add nothing.  Every
    other term is added, 0 · grad_out too (NaN where grad_out is inf or
    NaN, as the reference's gradient).  On the card the terms are sorted
    by row and added in a fixed order (see
    ``csrc/embedding_bag_backward.cu``): two calls give the same bits, and
    a row named at most PIECE times equals the item-order plain version;
    :func:`.ref.embedding_bag_backward_sorted_ref` adds in the kernel's
    order."""
    global backward_launches
    _check_backward(grad_out, indices, weights, num_rows)
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
    p = backward_plan(b * l, num_rows, d, grad_out.element_size(),
                      grad_out.data_ptr() % 16 == 0, sm_count(grad_out.device))
    work = torch.empty(p.workspace, dtype=torch.int32,
                       device=grad_out.device)
    launch = _backward_launcher()
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(grad_out.data_ptr(), indices.data_ptr(),
                     weights.data_ptr(), grad.data_ptr(), work.data_ptr(),
                     p.workspace, num_rows, b, l, d,
                     int(dtype == torch.bfloat16), int(p.vec > 1),
                     p.lanes.bit_length() - 1, p.keys_grid, p.sort_grid,
                     p.passes, p.reduce_grid, p.combine_grid, stream)
    if err != 0:
        raise RuntimeError(f"{BACKWARD} kernel launch failed: CUDA error "
                           f"{err}")
    backward_launches += 1
    return grad.to(dtype)


@embedding_bag_backward.register_fake
def _embedding_bag_backward_fake(grad_out, indices, weights, num_rows):
    _check_backward(grad_out, indices, weights, num_rows)
    return grad_out.new_empty((num_rows, grad_out.shape[1]))


def _setup_context(ctx, inputs, output):
    table, indices, weights = inputs
    ctx.save_for_backward(indices, weights)
    ctx.num_rows = table.shape[0]


def _backward(ctx, grad_out):
    indices, weights = ctx.saved_tensors
    grad = embedding_bag_backward(grad_out.contiguous(), indices, weights,
                                  ctx.num_rows)
    return grad, None, None


embedding_bag.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula([torch.ops.repro_torch.embedding_bag,
                        torch.ops.repro_torch.embedding_bag_backward])
def _embedding_bag_flops(first_shape, indices_shape, *args, **kwargs) -> int:
    """For the forward, ``first_shape`` is the table's [V, D]; for the
    backward, grad_out's [B, D]: D is the last either way."""
    b, l = indices_shape
    return 2 * b * l * first_shape[-1]
