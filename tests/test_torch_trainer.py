"""N steps of the port's ``Trainer`` against N steps of
``repro.train.trainer.Trainer`` from the same converted init on the same
batches: the LM smoke config and the four recsys smoke configs; and the
trainer's prefetch (skip-and-backfill), checkpoint cadence and the data
state it carries.

Tolerance: the reference's trainer run twice, in float32 and with its
weights widened to float64 under ``jax.enable_x64`` (its optimizer stays
float32), gives the spread of its own result; after N steps the port's
parameters must lie within RATIO (8) × that spread of the reference's
float32 parameters in the mean over each leaf, plus one float32 ulp of
the leaf's largest entry.  Element by element the bound is the larger
of RATIO × the spread's largest entry and what two AdamW runs that move
a coordinate in opposite directions can differ by (2 · 2.5 · lr a step):
the LM's embedding gradient passes through an RMS norm of rows of scale
0.02, and there the reference's own float32 and float64 gradients differ
by 4e-4 on entries of 2.7, enough to turn the first step's direction of
a coordinate whose gradient is near zero.
"""

import dataclasses
import os
import threading
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import lm_family as JLF  # noqa: E402
from repro.configs import recsys_family as JRF  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import lm_family as TLF  # noqa: E402
from repro_torch.configs import recsys_family as TRF  # noqa: E402
from repro_torch.convert import (model_tree, recsys_from_jax,  # noqa: E402
                                 transformer_from_jax)
from repro_torch.dist.checkpoint import Stacked, tree_leaves  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

RATIO = 8.0
STEPS = 3
# the most one AdamW step moves a coordinate, in units of lr: |m̂|/√v̂ is
# at most about √(1−b2)/(1−b1) ≈ 2.2 at these steps, plus the decay
FLIP_STEP = 2.5
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small ops; with a pool of 8 threads in each of
    the suite's parallel workers they oversubscribe the cores, so the
    module runs torch on one thread (and restores the count after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(name):
    if name in JLF.LM_SPECS:
        spec = JLF.LM_SPECS[name]
        return (spec, TLF.get_config(name, smoke=True),
                lambda s: TLF.smoke_batch(TLF.get_config(name, smoke=True),
                                          "train", seed=s),
                TLF.loss_fn)
    spec = JRF.RECSYS_SPECS[name]
    return (spec, TRF.get_config(name, smoke=True),
            lambda s: TRF.smoke_batch(name, "train", seed=s),
            lambda m, b: TRF.loss_fn(name, m, b))


def _ref_run(spec, params, batches):
    tc = JTR.TrainerConfig(total_steps=STEPS, ckpt_every=100, log_every=1,
                           opt=JO.AdamWConfig(**OPT))
    cfg = spec.smoke_config
    t = JTR.Trainer(lambda p, b: spec.loss_fn(p, cfg, b), params, tc,
                    iter(batches))
    t.train()
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(t.params)]


@pytest.mark.parametrize("name", ["internlm2-1.8b", "dlrm-rm2", "xdeepfm",
                                  "two-tower-retrieval", "sasrec"])
def test_trainer_steps_match_reference(name):
    spec, tcfg, make_batch, loss_fn = _spec(name)
    params = spec.init_fn(spec.smoke_config, jax.random.PRNGKey(0))
    np_params = jax.tree.map(lambda x: np.array(x), params)
    batches = [make_batch(s) for s in range(STEPS)]
    # the reference's step donates its parameters: each run gets a copy
    ref32 = _ref_run(spec, jax.tree.map(jnp.asarray, np_params), batches)
    with jax.enable_x64(True):
        ref64 = _ref_run(spec, jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float64), np_params), batches)
    model = (transformer_from_jax(np_params, tcfg, "cpu")
             if name in JLF.LM_SPECS else
             recsys_from_jax(np_params, tcfg, "cpu"))
    tc = TTR.TrainerConfig(total_steps=STEPS, ckpt_every=100, log_every=1,
                           opt=TO.AdamWConfig(**OPT))
    trainer = TTR.Trainer(loss_fn, model, tc, iter(batches))
    out = trainer.train()
    assert out["step"] == STEPS and len(out["metrics"]) == STEPS
    got = []
    for leaf in tree_leaves(model_tree(model)):
        got.append(torch.stack(list(leaf)) if isinstance(leaf, Stacked)
                   else leaf)
    assert len(got) == len(ref32)
    flip = 2 * FLIP_STEP * OPT["lr"] * STEPS
    for g, a, b in zip(got, ref32, ref64):
        d = np.abs(g.detach().double().numpy() - a)
        spread = np.abs(a - b)
        ulp = np.spacing(np.float32(np.abs(a).max()))
        assert d.mean() <= RATIO * spread.mean() + ulp, (
            name, g.shape, d.mean(), spread.mean())
        assert d.max() <= max(RATIO * spread.max() + ulp, flip), (
            name, g.shape, d.max(), spread.max())


def _model():
    return torch.nn.Linear(3, 1)


def _loss(m, b):
    return ((m(b["x"]) - b["y"]) ** 2).mean()


def _batches(n, state=False):
    rng = np.random.default_rng(0)
    for i in range(n):
        b = {"x": rng.standard_normal((4, 3)).astype(np.float32),
             "y": rng.standard_normal((4, 1)).astype(np.float32),
             "step": i}
        if state:
            b["_state"] = {"cursor": i + 1, "epoch": 0}
        yield b


def test_trainer_turns_gradients_on_and_logs_without_sync_between():
    m = _model().requires_grad_(False)
    tc = TTR.TrainerConfig(total_steps=6, log_every=3, ckpt_every=100)
    t = TTR.Trainer(_loss, m, tc, _batches(10))
    assert all(p.requires_grad for p in m.parameters())
    out = t.train()
    assert [x["step"] for x in out["metrics"]] == [3, 6]
    assert all(isinstance(x["loss"], float) for x in out["metrics"])
    assert int(t.opt_state["step"]) == 6


def test_prefetch_skips_a_straggler_and_backfills():
    def slow():
        for i, b in enumerate(_batches(6)):
            if i == 2:
                time.sleep(0.6)
            yield b
    tc = TTR.TrainerConfig(total_steps=5, straggler_timeout_s=0.2,
                           ckpt_every=100, log_every=100)
    t = TTR.Trainer(_loss, _model(), tc, slow())
    out = t.train()
    assert out["step"] == 5 and out["skipped"] >= 1


def test_consumed_data_state_rides_in_the_checkpoint(tmp_path):
    tc = TTR.TrainerConfig(total_steps=4, ckpt_every=2, log_every=100,
                           ckpt_dir=str(tmp_path), prefetch=3)
    t = TTR.Trainer(_loss, _model(), tc, _batches(10, state=True),
                    data_state_fn=lambda: {"cursor": -1, "epoch": -1})
    t.train()
    got = t.ckpt.restore(4, dict(t._tensor_state(), step=0,
                                 data={"cursor": 0, "epoch": 0}))
    assert got["data"] == {"cursor": 4, "epoch": 0} and got["step"] == 4
    assert t.ckpt.all_steps() == [2, 4]


def test_exhausted_iterator_ends_the_run():
    tc = TTR.TrainerConfig(total_steps=10, ckpt_every=100, log_every=100)
    out = TTR.Trainer(_loss, _model(), tc, _batches(3)).train()
    assert out["step"] == 3


def test_run_with_restarts_gives_up_after_max_failures(tmp_path):
    calls = []

    def make():
        calls.append(1)
        tc = TTR.TrainerConfig(total_steps=4, ckpt_every=1, log_every=100,
                               ckpt_dir=str(tmp_path))
        t = TTR.Trainer(_loss, _model(), tc, _batches(10))
        t.train = lambda fail_at=None: (_ for _ in ()).throw(
            RuntimeError("boom"))
        return t

    with pytest.raises(RuntimeError, match="boom"):
        TTR.run_with_restarts(make, max_failures=2)
    assert len(calls) == 3
