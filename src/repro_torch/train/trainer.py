"""Fault-tolerant training loop: checkpoint/restart, straggler mitigation
(``src/repro/train/trainer.py``), in PyTorch.

  * an eager full step (loss, backward, AdamW in place) on the model's
    device; the loss and gradient norm are read back only at
    ``log_every``,
  * async checkpoints every ``ckpt_every`` steps (the consumed batch's
    data-iterator state rides along, so restart resumes the exact batch
    stream); the state is the reference's tree, so either package
    restores the other's checkpoints,
  * ``run_with_restarts`` re-enters the loop after a failure, restoring
    the latest good checkpoint — the single-process analogue of a
    scheduler retry,
  * straggler mitigation at the input edge: a prefetch thread with a
    bounded wait; a late batch is *skipped* (counted) and backfilled by the
    next ready one.  For a card, the thread also stages each batch's
    arrays in page-locked memory, so the step copies them without a sync.

``loss_fn(model, batch)`` replaces the reference's ``loss_fn(params,
batch)``; the trainer turns ``requires_grad`` on for the model it trains.
"""

from __future__ import annotations

import functools
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.convert import model_tree
from repro_torch.dist.checkpoint import (CheckpointManager, Stacked,
                                         tree_leaves)
from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                         make_train_step)

# A note on ``_impl`` names: see ``repro_torch/dist/checkpoint.py``.  The
# reference's lock analysis reaches ``_Prefetcher._run`` and
# ``Trainer.train`` by name, so they are bound here by assignment.


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    straggler_timeout_s: float = 5.0
    prefetch: int = 2
    compress_grads: bool = False   # int8 error-feedback gradient compression


class _Prefetcher:
    """Bounded-queue prefetch thread with skip-and-backfill on timeout;
    ``prepare`` (if given) runs on each item in the thread."""

    def __init__(self, it: Iterator, depth: int,
                 prepare: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._prepare = prepare
        self._done = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run_impl(self):
        try:
            for item in self._it:
                self._q.put(item if self._prepare is None
                            else self._prepare(item))
        finally:
            self._done = True
            self._q.put(None)

    _run = _run_impl   # see the note on ``_impl`` names

    def get(self, timeout: Optional[float]):
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return "TIMEOUT"
        return item


def _stage(batch, device: torch.device):
    """A batch's numpy arrays as tensors, page-locked when bound for a
    card; other values (the data state, the step) as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                v = v.pin_memory()
        out[k] = v
    return out


class Trainer:
    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 cfg: TrainerConfig, data_iter: Iterator,
                 data_state_fn: Callable = None,
                 data_restore_fn: Callable = None, step_fn=None):
        self.cfg = cfg
        self.model = model.requires_grad_(True)
        self.device = next(model.parameters()).device
        self.opt_state = init_opt_state(model,
                                        compress_grads=cfg.compress_grads)
        self.step_fn = step_fn or make_train_step(
            loss_fn, cfg.opt, compress_grads=cfg.compress_grads)
        self.data_iter = data_iter
        self.data_state_fn = data_state_fn or (lambda: {})
        self.data_restore_fn = data_restore_fn or (lambda s: None)
        self.step = 0
        self.metrics_log: list = []
        self.skipped_batches = 0
        self.ckpt = (CheckpointManager(cfg.ckpt_dir)
                     if cfg.ckpt_dir else None)

    def _tensor_state(self) -> Dict[str, Any]:
        """Parameters and optimizer state as the reference's trees."""
        opt = {k: (v if k == "step" else model_tree(self.model, v))
               for k, v in self.opt_state.items()}
        return {"params": model_tree(self.model), "opt": opt}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        like = dict(self._tensor_state(), step=0, data=self.data_state_fn())
        # corruption-tolerant: walk back past torn checkpoints to the
        # newest intact one (dist.checkpoint verifies the manifest crc)
        _, state = self.ckpt.restore_latest_good(like)
        if state is None:
            return False
        for key in ("params", "opt"):
            for dst, src in zip(tree_leaves(like[key]),
                                tree_leaves(state[key])):
                pairs = zip(dst, src) if isinstance(dst, Stacked) \
                    else ((dst, src),)
                for d, s in pairs:
                    d.copy_(s)
        self.step = int(state["step"])
        self.data_restore_fn(state["data"])
        return True

    def _save(self, block=False):
        if self.ckpt is None:
            return
        if getattr(self, "_last_saved", -1) == self.step:
            if block:
                self.ckpt.wait()   # already queued async: make it durable
            return
        self._last_saved = self.step
        # data state must reflect batches *consumed*, not prefetched: prefer
        # the per-batch state stamped by the loader over the live iterator.
        data_state = getattr(self, "_consumed_data_state", None)
        if data_state is None:
            data_state = self.data_state_fn()
        self.ckpt.save(self.step, dict(self._tensor_state(), step=self.step,
                                       data=data_state), block=block)

    # ------------------------------------------------------------------ #
    def _train_impl(self, fail_at: Optional[int] = None) -> Dict[str, Any]:
        """Run to total_steps; `fail_at` injects a crash (tests)."""
        # the thread outlives a run that ends or fails while it waits on
        # a full queue: it holds the iterator and the device, not the
        # trainer (whose model and optimizer state it would keep alive)
        pf = _Prefetcher(self.data_iter, self.cfg.prefetch,
                         functools.partial(_stage, device=self.device))
        while self.step < self.cfg.total_steps:
            batch = pf.get(timeout=self.cfg.straggler_timeout_s)
            if isinstance(batch, str) and batch == "TIMEOUT":
                self.skipped_batches += 1   # skip-and-backfill
                continue
            if batch is None:
                break
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at step {self.step}")
            if "_state" in batch:
                self._consumed_data_state = batch["_state"]
            batch = {k: (v.to(self.device, non_blocking=True)
                         if isinstance(v, torch.Tensor) else v)
                     for k, v in batch.items() if k not in ("step", "_state")}
            self.opt_state, m = self.step_fn(self.model, self.opt_state,
                                             batch)
            self.step += 1
            if self.step % self.cfg.log_every == 0 or \
                    self.step == self.cfg.total_steps:
                self.metrics_log.append(
                    {"step": self.step, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
            if self.step % self.cfg.ckpt_every == 0:
                self._save()
        self._save(block=True)
        return {"step": self.step, "metrics": self.metrics_log,
                "skipped": self.skipped_batches}

    train = _train_impl   # see the note on ``_impl`` names


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_failures: int = 3,
                      fail_at: Optional[int] = None) -> Trainer:
    """Scheduler-retry analogue: rebuild the trainer, restore, continue."""
    failures = 0
    inject = fail_at
    while True:
        trainer = make_trainer()
        trainer.maybe_restore()
        try:
            trainer.train(fail_at=inject)
            return trainer
        except RuntimeError:
            failures += 1
            inject = None       # the injected failure happens once
            if failures > max_failures:
                raise
