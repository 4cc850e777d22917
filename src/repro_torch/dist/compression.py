"""Gradient compression: int8 quantization with error-feedback residuals
(``src/repro/dist/compression.py``), on a dict of tensors by name.

Each leaf is quantized independently against its own max-abs scale:

    scale = max|g + r| / 127          (one float32 per leaf)
    q     = round((g + r) / scale)    (int8, half to even)
    r'    = (g + r) - q * scale       (the rounding error, carried)

Carrying the residual makes the compressed stream unbiased over time.
This is the single-process half of the reference's module, the one
``Trainer(compress_grads=True)`` runs.  ``cross_pod_reduce_compressed``
(the mean over a pod axis with an int16 payload) needs a process group
and an int16 sum, which NCCL does not reduce; it is left to the
multi-card slice (ROADMAP).

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


def compression_ratio(tree: Mapping[str, torch.Tensor]) -> float:
    """Wire bytes of the compressed form relative to float32 (a float32
    scale a leaf)."""
    num = sum(v.numel() * 1 + 4 for v in tree.values())
    den = sum(v.numel() * 4 for v in tree.values())
    return num / max(den, 1)
