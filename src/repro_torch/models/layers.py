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

NEG_INF = -1e30


def _inv_sqrt(d: int) -> torch.Tensor:
    """1/√d as the JAX package computes it: a float32 sqrt, then 1/x."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
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
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


def causal_gqa_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Training-shape attention, in float32.

    q [B, S, Hkv, G, Dh]; k/v [B, S, Hkv, Dh] → [B, S, Hkv, G, Dh].  The G
    query heads of a group share their KV head without repeating it.
    """
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
