"""Gradient compression: int8 quantization with error-feedback residuals
(``src/repro/dist/compression.py``), on a dict of tensors by name.

Each leaf is quantized independently against its own max-abs scale:

    scale = max|g + r| / 127          (one float32 per leaf)
    q     = round((g + r) / scale)    (int8, half to even)
    r'    = (g + r) - q * scale       (the rounding error, carried)

Carrying the residual makes the compressed stream unbiased over time.
``compress_with_feedback`` is what ``Trainer(compress_grads=True)`` runs
on one process.  :func:`cross_pod_reduce_compressed` is the mean over a
mesh dimension (the pod axis) with a compressed payload, over a process
group: the reference's arithmetic, with its int16 sum carried in int32
words (see there; NCCL and gloo reduce no 16-bit integers).

Subnormals: XLA on the CPU flushes subnormal inputs and results to zero,
PyTorch does not, on the CPU or the card.  Where ``max|g + r|`` is below
127 · FLT_MIN the reference's scale is 0 and its residual keeps what it
read as x; the port keeps IEEE arithmetic (ROADMAP §3, faults (l), (q)).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.device import scalar

TINY = torch.finfo(torch.float32).tiny


def init_residual(tree: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Zero float32 error-feedback residuals shaped like ``tree``."""
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in tree.items()}


def _quantize_leaf(g: torch.Tensor, r: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = g.float() + r
    scale = x.abs().max() / scalar(127.0, x.device)
    safe = torch.maximum(scale, scalar(TINY, x.device))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    new_r = x - q.float() * scale
    return q, scale, new_r


def compress_with_feedback(grads: Mapping[str, torch.Tensor],
                           residual: Mapping[str, torch.Tensor]):
    """Quantize grads + residual; returns (int8 dict, scale dict,
    residual' dict), each by the grads' names."""
    q, s, r = {}, {}, {}
    for k, g in grads.items():
        q[k], s[k], r[k] = _quantize_leaf(g, residual[k])
    return q, s, r


def decompress(q: Mapping[str, torch.Tensor],
               scales: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Dequantize an int8 dict back to float32."""
    return {k: qi.float() * scales[k] for k, qi in q.items()}


MAX_PODS = 129      # ranks whose biased lane sums fit the int32 word


def cross_pod_reduce_compressed(grads: Mapping[str, torch.Tensor],
                                residual: Mapping[str, torch.Tensor],
                                mesh, axis_name: str = "pod"):
    """Mean-reduce ``grads`` (this rank's, by name) over the mesh dimension
    ``axis_name`` of ``mesh`` with a compressed payload; returns (reduced
    grads, residual'), each by name.

    The reference's arithmetic on n ranks: a shared scale from an
    all-reduce MAX of each leaf's max|g + r| (all leaves' scalars in one
    call) over 127; q = clip(round(x / safe), -127, 127); the residual
    against the shared scale; the sum of q, times the scale, over n.

    The payload.  The reference sums q as int16 (2 bytes a value); no
    NCCL or gloo reduction takes a 16-bit integer.  So each q + 127, in
    [0, 254], rides in one 16-bit lane of an int32 word (two values a
    word: still 2 bytes a value on the wire), all leaves in one int32
    all-reduce SUM; a lane's sum is at most 254·n, so the low lane never
    carries into the high one (254·n < 2^16) and the high lane's sum stays
    under 2^15, so no word overflows, for n ≤ 129 = ``MAX_PODS``.  Each
    lane's sum minus 127·n is exactly the reference's psum(q).  Above 129
    ranks (the reference's int16 claims 256) this raises."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if n > MAX_PODS:
        raise ValueError(
            f"{n} ranks on {axis_name!r}: the int32 word of two 16-bit "
            f"lanes holds the sum of at most {MAX_PODS} (254·n < 2^15 in "
            f"the high lane)")
    names = list(grads)
    xs = [grads[k].float() + residual[k] for k in names]
    dev = xs[0].device
    amax = torch.stack([x.abs().max() for x in xs])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scales, qs, new_r = [], [], {}
    for i, (k, x) in enumerate(zip(names, xs)):
        scale = amax[i] / scalar(127.0, dev)
        safe = torch.maximum(scale, scalar(TINY, dev))
        q = torch.clamp(torch.round(x / safe), -127, 127)
        new_r[k] = x - q * scale
        scales.append(scale)
        qs.append(q.to(torch.int32).reshape(-1) + 127)
    flat = torch.cat(qs)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.view(-1, 2)
    words = pairs[:, 0] | (pairs[:, 1] << 16)
    dist.all_reduce(words, op=dist.ReduceOp.SUM, group=group)
    total = torch.stack([words & 0xFFFF, words >> 16], dim=1).reshape(-1) \
        - 127 * n
    reduced, at = {}, 0
    for k, x, scale in zip(names, xs, scales):
        t = total[at:at + x.numel()].view(x.shape)
        at += x.numel()
        reduced[k] = t.float() * scale / n
    return reduced, new_r


def compression_ratio(tree: Mapping[str, torch.Tensor]) -> float:
    """Wire bytes of the compressed form relative to float32 (a float32
    scale a leaf)."""
    num = sum(v.numel() * 1 + 4 for v in tree.values())
    den = sum(v.numel() * 4 for v in tree.values())
    return num / max(den, 1)
