"""Shared model layers: RMSNorm, RoPE, GQA attention, SwiGLU, in PyTorch.

The public functions keep the JAX package's layouts: activations
``[B, S, D]``, queries ``[B, S, Hkv, G, Dh]``, keys and values
``[B, S, Hkv, Dh]``, weights ``[in, out]`` (the products are ``x @ w``, left
to ``torch.matmul`` as the JAX package left them to XLA).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist.on_mesh import (contiguous_grad, gather_last,
                                      grad_like, is_dtensor, keep_shards,
                                      rowwise)

NEG_INF = -1e30


def _inv_sqrt(d: int) -> torch.Tensor:
    """1/√d as the JAX package computes it: a float32 sqrt, then 1/x."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    if is_dtensor(x):      # each rank its own rows (on_mesh.rowwise)
        return rowwise(lambda a, w: rms_norm(a, w, eps), x, weight)
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10_000.0,
                     device=None):
    """(cos, sin), each float32 ``[max_len, head_dim / 2]``: the same float64
    numpy table as the JAX package, rounded once to float32, so the two are
    bit-equal."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_len), inv)                 # [S, D/2]
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor = None) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [max_len, D/2]; positions [..., S] optional.

    Positions at or past the table's end are clamped to its last row: JAX
    clamps an out-of-range gather silently, torch would raise.
    """
    if positions is None:
        s = x.shape[-3]
        c = cos[:s][:, None, :]
        sn = sin[:s][:, None, :]
    else:
        pos = positions.clamp(0, cos.shape[0] - 1)
        c = cos[pos][..., None, :]
        sn = sin[pos][..., None, :]
    return rope_rotate(x, c, sn)


def rope_rotate(x: torch.Tensor, c: torch.Tensor,
                sn: torch.Tensor) -> torch.Tensor:
    """x [..., D] rotated by float32 rows c, sn [..., D/2] that broadcast
    against it (the table rows ``apply_rope`` gathers)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * sn, x1 * sn + x2 * c], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    # on DTensors: the hidden's batch and width cuts only (Megatron's),
    # and each gradient back in its own tensor's placement (DTensor's
    # backward would cut the sequence too, which the weights' gradient
    # products cannot flatten)
    g = grad_like(torch.matmul(x, w_gate))
    u = grad_like(torch.matmul(x, w_up))
    h = grad_like(keep_shards(F.silu(g) * u, (0, g.dim() - 1)))
    return torch.matmul(h, w_down)


def per_head(fn, q, k, v, **kwargs):
    """``fn(q, k, v, **kwargs)`` on DTensors, each rank on its own batch
    rows and KV heads (dims 0 and 2 of q, k and v, where all three are cut
    alike; whole elsewhere): attention is independent across both, and
    DTensor's own products would flatten a cut batch and cut heads into a
    strided shard it cannot multiply.  The local tensors and gradients
    that leave the ``local_map`` are contiguous: DTensor views them as
    its global layout says they are."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    q, k, v = (keep_shards(x, (0, 2)) for x in (q, k, v))
    common = [p if p == k.placements[i] == v.placements[i] else Replicate()
              for i, p in enumerate(q.placements)]
    def local(a, b, c):
        a, b, c = (contiguous_grad(x) for x in (a, b, c))
        return fn(a, b, c, **kwargs).contiguous()

    return local_map(local, out_placements=common,
                     in_placements=(common, common, common),
                     device_mesh=q.device_mesh, redistribute_inputs=True)(
        q, k, v)


def causal_gqa_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Training-shape attention, in float32.

    q [B, S, Hkv, G, Dh]; k/v [B, S, Hkv, Dh] → [B, S, Hkv, G, Dh].  The G
    query heads of a group share their KV head without repeating it.
    """
    if is_dtensor(q):
        return per_head(causal_gqa_attention, q, k, v)
    s, dh = q.shape[1], q.shape[-1]
    scale = _inv_sqrt(dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.to(q.dtype)


def decode_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         length: torch.Tensor) -> torch.Tensor:
    """Decode-shape attention (one new token against the cache), the model
    side's twin of the ``gqa_decode`` kernel.

    q [B, Hkv, G, Dh]; caches [B, S, Hkv, Dh]; length [B] → [B, Hkv, G, Dh].
    Positions at or past ``length`` are masked with a finite -1e30, so a
    sequence of length 0 gets the mean of V (the kernel gives 0 there).
    """
    s, dh = k_cache.shape[1], q.shape[-1]
    scale = _inv_sqrt(dh)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(),
                          k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    scores = torch.where(pos < length[:, None, None, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = out / p.sum(dim=-1)[..., None]
    return out.to(q.dtype)


def chunked_causal_gqa_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, q_chunk: int,
                                 kv_chunk: int) -> torch.Tensor:
    """Flash-style blocked causal attention in plain PyTorch, the
    reference's pure-jnp online softmax (``layers.py:69``): scores never
    exceed [B, Hkv, G, q_chunk, kv_chunk]; a running (m, l, acc) over KV
    chunks for each query chunk, in float32.

    q [B, S, Hkv, G, Dh]; k/v [B, S, Hkv, Dh] → [B, S, Hkv, G, Dh]; S a
    multiple of both chunks.  A KV chunk that lies wholly after a query
    chunk's last position is skipped: the reference adds it with every
    score masked to -1e30, which leaves (m, l, acc) bit for bit as they
    were (alpha = 1, p = 0), since the first KV chunk already set m.
    """
    if is_dtensor(q):
        return per_head(chunked_causal_gqa_attention, q, k, v,
                        q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, s, hkv, g, dh = q.shape
    nq, nk = s // q_chunk, s // kv_chunk
    scale = _inv_sqrt(dh)            # a CPU scalar: no copy to the card
    qc = q.reshape(b, nq, q_chunk, hkv, g, dh)
    kc = k.reshape(b, nk, kv_chunk, hkv, dh)
    vc = v.reshape(b, nk, kv_chunk, hkv, dh)
    blocks = []
    for qi in range(nq):
        q_tile = qc[:, qi].float()
        m = torch.full((b, hkv, g, q_chunk, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        for kj in range(nk):
            if kj * kv_chunk > (qi + 1) * q_chunk - 1:
                break                       # wholly masked (see above)
            sco = torch.einsum("bqhgd,bkhd->bhgqk", q_tile,
                               kc[:, kj].float()) * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            sco = torch.where(mask, sco, NEG_INF)
            m_new = torch.maximum(m, sco.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sco - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                             vc[:, kj].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        blocks.append(out.permute(0, 3, 1, 2, 4))   # [B, q_chunk, Hkv, G, Dh]
    return torch.cat(blocks, dim=1).to(q.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross entropy in float32; labels equal to ``ignore_id``
    are masked (``layers.py:145``).  The loader pads with label 0, which
    is not masked and counts, as in the reference."""
    logits = logits.float()
    mask = labels != ignore_id
    labels_safe = torch.where(mask, labels, 0).long()
    if is_dtensor(logits):    # max and sum over the cut vocabulary
        m = logits.amax(dim=-1, keepdim=True).detach()
        e = grad_like(torch.exp(logits - m))
        logz = (m + torch.log(e.sum(-1, keepdim=True)))[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
    gold = gather_last(logits, labels_safe)
    nll = grad_like((logz - gold) * mask)
    return nll.sum() / torch.clamp(mask.sum(), min=1)
