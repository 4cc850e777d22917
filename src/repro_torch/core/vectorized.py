"""Batched device programs: the GCL array algebra, the dense BM25 scorer
and an exact top-k.

The lazy engine (``gcl.py``) chases one cursor at a time.  Here the same
operators are array programs over struct-of-arrays GC-lists, as in the
reference package's ``core/vectorized.py``, with its layout at every public
function: int32 starts and ends, fixed-size outputs, and entries whose
start is ``PAD`` (= int32 max) invalid.

* τ/ρ are ``searchsorted`` probes over the starts/ends (batched over k);
* the containment masks go through the ``interval_join`` kernel on the
  card (its plain version on the CPU) — one probe per element of A;
* the combination operators build one candidate per input element and
  G-reduce them with a sort plus a suffix minimum; the sorts, ``cummin``
  and searches stay PyTorch ops, as the reference leaves them to XLA;
* :func:`stable_topk` is a top-k with the tie order of
  ``jax.lax.top_k`` (values descending, equal values by lower index),
  which the server's result order and any later k-way merge rely on;
* :func:`bm25_topk` is the dense scatter-add scorer the server calls once
  per micro-batch.

A GC-list here is what ``pack`` makes of a G-reduced list: valid starts
strictly increase, so do valid ends, and the PAD entries form the tail.
``contained_in`` and ``containing`` (and their masks and negations) need B
to be one.  The containment operators' outputs are GC-lists again; the
combination operators' outputs keep the reference's layout (valid entries
in start order, PAD entries left in place), and :func:`compact` makes them
GC-lists.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PAD = np.int32(np.iinfo(np.int32).max)


def pack(starts, ends, values=None, size: int = None, device=None):
    """Host → device: pad a GC-list to `size` entries."""
    n = len(starts)
    size = size or max(n, 1)
    s = np.full(size, PAD, dtype=np.int32)
    e = np.full(size, PAD, dtype=np.int32)
    v = np.zeros(size, dtype=np.float32)
    s[:n] = starts
    e[:n] = ends
    if values is not None:
        v[:n] = values
    return (torch.from_numpy(s).to(device), torch.from_numpy(e).to(device),
            torch.from_numpy(v).to(device))


def unpack(s, e, v=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    s, e = s.cpu().numpy(), e.cpu().numpy()
    keep = s != PAD
    vv = v.cpu().numpy()[keep] if v is not None else np.zeros(keep.sum())
    return s[keep], e[keep], vv


_PAD = int(PAD)


def compact(s, e, v=None):
    """Move a list's PAD entries to its tail, the valid entries keeping
    their order (a stable sort by start).  A combination operator's output
    becomes a GC-list, which ``contained_in``/``containing`` take as B.
    Returns (s, e), or (s, e, v) when values are given."""
    order = torch.argsort(s, stable=True)     # jnp.argsort is stable
    if v is None:
        return s[order], e[order]
    return s[order], e[order], v[order]


# --------------------------------------------------------------------- #
# access methods: batched τ/ρ
# --------------------------------------------------------------------- #
def tau(starts, ends, k):
    """Batched τ: first annotation with start >= k (k may be an array)."""
    k = torch.as_tensor(k, device=starts.device)
    i = torch.searchsorted(starts, k, side="left")
    i = i.clamp_(max=starts.shape[0] - 1)
    s, e = starts[i], ends[i]
    ok = s >= k
    return torch.where(ok, s, _PAD), torch.where(ok, e, _PAD)


def rho(starts, ends, k):
    """Batched ρ: first annotation with end >= k."""
    k = torch.as_tensor(k, device=starts.device)
    i = torch.searchsorted(ends, k, side="left")
    i = i.clamp_(max=ends.shape[0] - 1)
    s, e = starts[i], ends[i]
    ok = e >= k
    return torch.where(ok, s, _PAD), torch.where(ok, e, _PAD)


# --------------------------------------------------------------------- #
# G-reduction: parallel minimality mask over candidate intervals
# --------------------------------------------------------------------- #
def g_reduce_mask(s, e):
    """Given candidate intervals (PAD-padded), return (s, e, keep_mask,
    order) with the surviving minimal intervals, sorted by start.

    The sort is ``jnp.lexsort((e, s))``'s: by start, then end, stable.
    Torch has no lexsort, so it is one stable sort of the int64 key
    ``s·2³² + (e + 2³¹)``, which orders any int32 pair the same way.  PAD
    entries sort to the tail.  Equal (p,q) duplicates keep one
    representative (the first after the stable sort)."""
    key = (s.to(torch.int64) << 32) + (e.to(torch.int64) + (1 << 31))
    order = torch.argsort(key, stable=True)
    s, e = s[order], e[order]
    valid = s != _PAD
    first = torch.zeros(1, dtype=torch.bool, device=s.device)
    eq_start = torch.cat([first, s[1:] == s[:-1]])
    # drop exact duplicates
    dup = torch.cat([first, (s[1:] == s[:-1]) & (e[1:] == e[:-1])])
    # equal-start run: keep first (others contain it); an interval contains
    # a later-starting one iff its end >= the suffix-min of later ends
    e_for_min = torch.where(valid & ~dup, e, _PAD)
    suffix_min = torch.cummin(e_for_min.flip(0), 0).values.flip(0)
    nxt = torch.cat([suffix_min[1:], torch.full_like(suffix_min[:1], _PAD)])
    keep = valid & ~dup & ~eq_start & (e < nxt)
    return s, e, keep, order


# --------------------------------------------------------------------- #
# containment operators: masks over A
# --------------------------------------------------------------------- #
def _join_mask(a_s, a_e, b_s, b_e, mode):
    # imported here: the kernel package imports this module
    from repro_torch.kernels.interval_join import interval_join
    return interval_join(a_s, a_e, b_s, b_e, mode=mode) != 0


def contained_in_mask(a_s, a_e, b_s, b_e):
    """bool mask[i]: A[i] ⊑ some B[j], B a GC-list (:func:`compact` makes
    a combination operator's output one).  First B ending >= A.end must
    start <= A.start."""
    return _join_mask(a_s, a_e, b_s, b_e, "contained_in")


def containing_mask(a_s, a_e, b_s, b_e):
    """bool mask[i]: A[i] ⊒ some B[j], B a GC-list (:func:`compact` makes
    a combination operator's output one).  First B starting >= A.start
    must end <= A.end."""
    return _join_mask(a_s, a_e, b_s, b_e, "containing")


def _apply_mask(a_s, a_e, a_v, mask):
    return compact(torch.where(mask, a_s, _PAD), torch.where(mask, a_e, _PAD),
                   torch.where(mask, a_v, 0.0))


def contained_in(a_s, a_e, a_v, b_s, b_e):
    return _apply_mask(a_s, a_e, a_v, contained_in_mask(a_s, a_e, b_s, b_e))


def containing(a_s, a_e, a_v, b_s, b_e):
    return _apply_mask(a_s, a_e, a_v, containing_mask(a_s, a_e, b_s, b_e))


def not_contained_in(a_s, a_e, a_v, b_s, b_e):
    m = ~contained_in_mask(a_s, a_e, b_s, b_e) & (a_s != _PAD)
    return _apply_mask(a_s, a_e, a_v, m)


def not_containing(a_s, a_e, a_v, b_s, b_e):
    m = ~containing_mask(a_s, a_e, b_s, b_e) & (a_s != _PAD)
    return _apply_mask(a_s, a_e, a_v, m)


# --------------------------------------------------------------------- #
# combination operators: candidates + parallel G-reduce
# --------------------------------------------------------------------- #
def _rho_b(b_s, b_e, k):
    """Backward ρ: last B with end <= k; PAD-aware (PAD entries sort high)."""
    j = torch.searchsorted(b_e, k, side="right") - 1
    ok = j >= 0
    j = j.clamp_(min=0)
    return torch.where(ok, b_s[j], _PAD), torch.where(ok, b_e[j], _PAD)


def _reduced(s, e):
    s, e, keep, _ = g_reduce_mask(s, e)
    return torch.where(keep, s, _PAD), torch.where(keep, e, _PAD)


def both_of(a_s, a_e, b_s, b_e):
    """A △ B.  Candidates: for each a: (min(a.p, ρ'_B(a.q).p), a.q), plus the
    symmetric set anchored at B (gcl.BothOf's derivation)."""
    def anchored(x_s, x_e, y_s, y_e):
        ys, _ = _rho_b(y_s, y_e, x_e)
        ok = (x_s != _PAD) & (ys != _PAD)
        return (torch.where(ok, torch.minimum(x_s, ys), _PAD),
                torch.where(ok, x_e, _PAD))

    ca_s, ca_e = anchored(a_s, a_e, b_s, b_e)
    cb_s, cb_e = anchored(b_s, b_e, a_s, a_e)
    return _reduced(torch.cat([ca_s, cb_s]), torch.cat([ca_e, cb_e]))


def one_of(a_s, a_e, b_s, b_e):
    return _reduced(torch.cat([a_s, b_s]), torch.cat([a_e, b_e]))


def followed_by(a_s, a_e, b_s, b_e):
    """A ◇ B: for each b, pair with the last A ending < b.p.  ``b_s - 1``
    stays int32: PAD - 1 does not wrap."""
    as_, _ = _rho_b(a_s, a_e, b_s - 1)
    ok = (b_s != _PAD) & (as_ != _PAD)
    return _reduced(torch.where(ok, as_, _PAD), torch.where(ok, b_e, _PAD))


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim of a float32 tensor: values descending,
    ties broken by the lower index — the order a stable descending sort
    gives, computed without sorting the row.

    Each element gets a unique int64 key: the float's bits mapped to an
    integer of the same order (negative floats have their magnitude bits
    flipped) in the high word, and ``2^32 - 1 - index`` in the low word.
    One ``torch.topk`` over the keys then has no ties to order, and no
    value leaves the device.  The key is the raw bits, so ``-0.0`` ranks
    just below ``+0.0``, as in ``lax.top_k``.
    """
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"k={k} outside [0, {n}]")
    if x.dtype != torch.float32:
        raise TypeError(f"stable_topk takes float32, got {x.dtype}")
    bits = x.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key.mul_(1 << 32).add_(
        (1 << 32) - 1 - torch.arange(n, dtype=torch.int64, device=x.device))
    _, idx = torch.topk(key, k, dim=-1)
    return torch.gather(x, -1, idx), idx


def bm25_topk(doc_idx: torch.Tensor, impacts: torch.Tensor,
              qmask: torch.Tensor, n_docs: int, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched exhaustive BM25 on the tensors' device.

    doc_idx  [Q, T, L] int32 padded with n_docs (the dropped slot)
    impacts  [Q, T, L] f32, zero where padded
    qmask    [Q, T]    f32 per-query term weights (0 = absent term)
    returns  (scores [Q, k] f32, ids [Q, k] int64)

    The accumulator is one flat ``[Q * (n_docs + 1)]`` buffer: row q's
    slot ``n_docs`` takes the padding and is never read.  It is filled by
    one ``index_add_`` per term, in term order.  Within one term the
    (query, doc) targets are distinct (padding aside), so no two updates of
    one call meet and every document's sum runs t = 0, 1, … exactly as the
    reference scatter does — the same bits, run after run, on either
    device.
    """
    q, t, _ = doc_idx.shape
    width = n_docs + 1
    acc = torch.zeros(q * width, dtype=torch.float32, device=impacts.device)
    rows = (torch.arange(q, device=impacts.device) * width).view(q, 1)
    contrib = impacts * qmask[:, :, None]
    for ti in range(t):
        acc.index_add_(0, (doc_idx[:, ti, :] + rows).reshape(-1),
                       contrib[:, ti, :].reshape(-1))
    return stable_topk(acc.view(q, width)[:, :n_docs], k)
