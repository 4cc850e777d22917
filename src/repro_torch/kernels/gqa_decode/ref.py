"""Plain PyTorch version of flash-decoding GQA attention, with the Pallas
kernel's semantics (``src/repro/kernels/gqa_decode/kernel.py``).

q [B, Hkv, G, D]; k/v [B, S, Hkv, D]; length [B] int32 → [B, Hkv, G, D]:

  scale = 1/√D in float32; scores = (q·k)·scale in float32 (bfloat16
  inputs widened); positions at or past ``length[b]`` do not count; a
  ``length`` above S means all S positions; ``length == 0`` gives zeros
  (the Pallas kernel skips every tile and returns acc / max(l, 1e-30)).

The JAX package has two other references that differ only at length 0:
``gqa_decode_ref`` (masks with -inf, gives NaN) and
``layers.decode_gqa_attention`` (masks with -1e30, gives the mean of V).
"""

import torch


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    d, s = q.shape[-1], k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, None, :] < length[:, None, None, None]
    scores = torch.where(valid, scores, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = acc / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)
