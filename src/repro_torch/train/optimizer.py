"""AdamW with clipping and schedules, in PyTorch (``src/repro/train/
optimizer.py``).

Not ``torch.optim.AdamW``: that decays ``p`` before its step, where the
reference adds ``weight_decay · p`` to the update (``optimizer.py:65``).
The schedule, the clip scale and the bias corrections are float32 tensors
on the parameters' device, as the reference computes them, so a step
reads nothing back to the host; ``mu`` and ``nu`` are float32 for bf16
parameters too.

The state is a dict: ``mu`` and ``nu`` map each parameter's name to its
float32 moment, ``step`` is an int32 scalar tensor, and ``ef`` (with
``compress_grads``) holds the error-feedback residuals.  The update works
in place, a chunk of ``CHUNK`` elements at a time, with the reference's
operations in its order (separate products and sums, no fused
multiply-add): done out of place as the reference does, its float32
temporaries over DLRM-RM2's 6.66 GB table would need about 40 GB.  Given
the same scalars, a leaf's update equals the reference's bit for bit on
the CPU; the scalars themselves go through float32 ``cos`` and ``pow``,
which XLA and PyTorch round differently in the last place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import torch

from repro_torch.device import scalar

CHUNK = 1 << 26          # elements a leaf is updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return scalar(float(x), torch.device(device))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio · lr``: a float32
    scalar tensor on ``step``'s device."""
    dev = step.device
    step = step.to(torch.float32)
    warm = step / _f32(max(cfg.warmup_steps, 1), dev)
    prog = torch.clamp((step - _f32(cfg.warmup_steps, dev))
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0, 1)
    cos = _f32(0.5, dev) * (1 + torch.cos(_f32(math.pi, dev) * prog))
    decay = _f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) * cos
    return _f32(cfg.lr, dev) * torch.where(
        step < _f32(cfg.warmup_steps, dev), warm, decay)


def init_opt_state(model: torch.nn.Module,
                   compress_grads: bool = False) -> Dict:
    """Zero float32 moments for every parameter of ``model`` (by name), the
    step at 0, and with ``compress_grads`` zero residuals."""
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for n, p in named.items()}

    state = {"mu": zeros(), "nu": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if compress_grads:
        from repro_torch.dist import compression
        state["ef"] = compression.init_residual(
            {n: p for n, p in named.items()})
    return state


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ leaves Σ x²) in float32, a scalar tensor (a chunk of a leaf is
    squared at a time, so no leaf-sized temporary is made)."""
    total = None
    for leaf in tree.values():
        for part in leaf.reshape(-1).split(CHUNK):
            sq = part.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def _update_leaf(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
                 mu: torch.Tensor, nu: torch.Tensor, scale: torch.Tensor,
                 lr: torch.Tensor, bc1: torch.Tensor,
                 bc2: torch.Tensor) -> None:
    """One leaf's AdamW step, in place, the reference's ``upd`` operation
    for operation: g·scale; mu = b1·mu + (1−b1)·g; nu = b2·nu +
    ((1−b2)·g)·g; delta = (mu/bc1) / (√(nu/bc2) + eps) + wd·p;
    p = p − lr·delta, cast to p's dtype."""
    for pc, gc, mc, nc in zip(p.view(-1).split(CHUNK), g.reshape(-1).split(
            CHUNK), mu.view(-1).split(CHUNK), nu.view(-1).split(CHUNK)):
        gf = gc.float() * scale
        mc.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
        nc.mul_(cfg.b2).add_((gf * (1 - cfg.b2)).mul_(gf))
        delta = mc / bc1
        delta.div_(torch.sqrt(nc / bc2).add_(cfg.eps))
        pf = pc.float()
        delta.add_(pf * cfg.weight_decay)
        pc.copy_(pf - lr * delta)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict) -> Dict:
    """One AdamW step over ``params`` (by name) with ``grads``, in place:
    the parameters, ``state["mu"]``, ``state["nu"]`` and ``state["step"]``
    change.  Returns ``{"grad_norm", "lr"}``, scalar tensors on the
    device (no host sync)."""
    state["step"].add_(1)
    dev = state["step"].device
    stepf = state["step"].to(torch.float32)
    gn = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.grad_clip, dev)
                          / torch.maximum(gn, _f32(1e-9, dev)))
    lr = lr_schedule(cfg, state["step"])
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), stepf)
    for name, p in params.items():
        _update_leaf(cfg, p, grads[name], state["mu"][name],
                     state["nu"][name], scale, lr, bc1, bc2)
    return {"grad_norm": gn, "lr": lr}


def make_train_step(loss_fn: Callable, opt_cfg: Optional[AdamWConfig] = None,
                    compress_grads: bool = False) -> Callable:
    """``loss_fn(model, batch)`` → scalar; returns ``step(model, opt_state,
    batch)`` → ``(opt_state, metrics)``: the loss and its gradients, then
    (with ``compress_grads``) the gradients through int8 error-feedback
    quantization (the residual rides in ``opt_state["ef"]``), then the
    AdamW update, all in place.  ``metrics`` holds ``loss``, ``grad_norm``
    and ``lr`` as tensors on the device: reading them is the host sync.

    The reference's ``reduce_axis`` (a mean over a mesh axis with a
    compressed payload, ``cross_pod_reduce_compressed``) belongs to the
    multi-card slice and is not here."""
    opt_cfg = opt_cfg or AdamWConfig()
    if compress_grads:
        from repro_torch.dist import compression

    def step(model: torch.nn.Module, opt_state: Dict, batch):
        params = dict(model.named_parameters())
        loss = loss_fn(model, batch)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if compress_grads:
            q, s, opt_state["ef"] = compression.compress_with_feedback(
                grads, opt_state["ef"])
            grads = compression.decompress(q, s)
        metrics = adamw_update(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss.detach()
        return opt_state, metrics

    return step
