"""The transformer's training side in the port against
``repro.models.{layers,transformer}``: blocked attention, cross entropy,
``loss_fn`` and its gradients, remat; and the index-backed trainer's
crash and restart, and the train launcher, on the CPU.

Tolerances come from the reference's own spread: its float32 result
against its float64 result (``jax.enable_x64``, the same
weights widened; where the reference casts to float32 inside, the same
formula in numpy float64), or its chunked attention against its full
one.  The port's float32 result must lie within RATIO (8,
as the recsys tests) × that spread of the reference's float32, plus one
float32 ulp of the largest entry; chunked against unchunked attention
follows ``tests/test_perf_paths.py`` (2e-5 on values, 2e-4 in a model).
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

def enable_x64():
    return jax.enable_x64(True)

from repro.configs import lm_family as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import lm_family as TF  # noqa: E402
from repro_torch.convert import model_tree, transformer_from_jax  # noqa
from repro_torch.dist.checkpoint import Stacked, tree_leaves  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

RATIO = 8.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small ops; with a pool of 8 threads in each of
    the suite's parallel workers they oversubscribe the cores, so the
    module runs torch on one thread (and restores the count after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def within_spread(got, ref32, ref64, what=""):
    """|got − ref32| ≤ RATIO · max|ref32 − ref64| + ulp(max|ref64|)."""
    got, ref32, ref64 = (np.asarray(x, np.float64) for x in (got, ref32,
                                                             ref64))
    spread = np.abs(ref32 - ref64).max()
    floor = np.spacing(np.float32(np.abs(ref64).max()))
    err = np.abs(got - ref32).max()
    assert err <= RATIO * spread + floor, (what, err, spread)
    return err, spread


def _qkv(rng, b=2, s=64, hkv=2, g=3, d=16):
    return (rng.standard_normal((b, s, hkv, g, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("s,qc,kc", [(64, 16, 16), (128, 32, 64),
                                     (96, 32, 32), (64, 32, 16)])
def test_chunked_attention_matches_reference_and_full(s, qc, kc):
    rng = np.random.default_rng(s + qc)
    q, k, v = _qkv(rng, s=s)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(JL.chunked_causal_gqa_attention(
        jq, jk, jv, q_chunk=qc, kv_chunk=kc))
    ref_full = np.asarray(JL.causal_gqa_attention(jq, jk, jv))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = TL.chunked_causal_gqa_attention(tq, tk, tv, q_chunk=qc,
                                          kv_chunk=kc)
    # the reference computes in float32 inside: its chunked-vs-full
    # spread is the yardstick
    within_spread(got.numpy(), ref, ref_full, "chunked")
    full = TL.causal_gqa_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_chunked_attention_gradients_match_full():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(rng, s=96))
    w = torch.from_numpy(rng.standard_normal((2, 96, 2, 3, 16)).astype(
        np.float32))
    grads = []
    for fn in (lambda: TL.causal_gqa_attention(q, k, v),
               lambda: TL.chunked_causal_gqa_attention(q, k, v, q_chunk=32,
                                                       kv_chunk=16)):
        out = (fn() * w).sum()
        grads.append(torch.autograd.grad(out, (q, k, v)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_value_and_gradient(ignore):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    if ignore:
        labels[0, :4] = -1
    jv, jg = jax.value_and_grad(JL.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    # the reference casts to float32 inside, so its float64 twin is the
    # same formula in numpy float64
    x = logits.astype(np.float64)
    mask = labels != -1
    lz = np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) + x.max(-1)
    gold = np.take_along_axis(x, np.where(mask, labels, 0)[..., None],
                              -1)[..., 0]
    n = max(mask.sum(), 1)
    jv64 = ((lz - gold) * mask).sum() / n
    p = np.exp(x - lz[..., None])
    p[np.arange(2)[:, None], np.arange(9)[None], np.where(mask, labels, 0)
      ] -= 1
    jg64 = p * mask[..., None] / n
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = TL.cross_entropy_loss(t, torch.from_numpy(labels))
    tv.backward()
    within_spread(tv.item(), jv, jv64, "loss")
    within_spread(t.grad.numpy(), jg, jg64, "grad")


def _smoke(**over):
    jcfg = dataclasses.replace(JF.LM_SPECS["internlm2-1.8b"].smoke_config,
                               **over)
    tcfg = dataclasses.replace(TF.get_config("internlm2-1.8b", smoke=True),
                               **over)
    return jcfg, tcfg


def _flat(tree):
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, Stacked):
            out.append(torch.stack(list(leaf)).numpy())
        else:
            out.append(leaf.numpy())
    return out


@pytest.mark.parametrize("over", [{}, {"remat": True},
                                  {"attn_chunk_q": 16, "attn_chunk_kv": 32}],
                         ids=["plain", "remat", "chunked"])
def test_loss_fn_value_and_gradients_match_reference(over):
    jcfg, tcfg = _smoke(**over)
    params = JT.init_params(jcfg, jax.random.PRNGKey(2))
    batch = TF.smoke_batch(tcfg, "train", seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jv, jg = jax.value_and_grad(JT.loss_fn)(params, jb, jcfg)
    with enable_x64():
        p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        jv64, jg64 = jax.value_and_grad(JT.loss_fn)(p64, jb, jcfg)
    model = transformer_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu").requires_grad_(True)
    loss = TF.loss_fn(model, batch)
    loss.backward()
    within_spread(loss.item(), jv, jv64, "loss")
    grads = model_tree(model, {n: p.grad for n, p in
                               model.named_parameters()})
    got = _flat(grads)
    assert len(got) == len(jax.tree.leaves(jg))
    for g, a, b in zip(got, jax.tree.leaves(jg), jax.tree.leaves(jg64)):
        within_spread(g, a, b, "grad")


def test_forward_builds_a_graph_only_when_training():
    _, cfg = _smoke(remat=True)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    assert not TT.forward(model, toks).requires_grad
    assert not TT.prefill(model, toks).requires_grad
    model.requires_grad_(True)
    assert TT.forward(model, toks).requires_grad
    assert not TT.prefill(model, toks).requires_grad


# ------------------------------------------------------------------ #
# the index-backed trainer: crash and restart, and the launcher
# ------------------------------------------------------------------ #
def _index_run(tmp, steps, crash_at=None):
    from repro_torch.core import DynamicIndex, Warren
    from repro_torch.data.pipeline import (IndexedCorpusLoader, ingest,
                                           mark_duplicates, segment)
    from repro_torch.data.synth import doc_generator
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           run_with_restarts)
    _, cfg = _smoke()
    warren = Warren(DynamicIndex())
    ingest(warren, doc_generator(0, 30, mean_len=60))
    mark_duplicates(warren)
    segment(warren, window=32, stride=16)

    def make():
        loader = IndexedCorpusLoader(warren, vocab=cfg.vocab, batch=2,
                                     seq_len=32)
        tc = TrainerConfig(total_steps=steps, ckpt_every=3,
                           ckpt_dir=str(tmp), log_every=1,
                           opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=steps))
        return Trainer(TF.loss_fn, TT.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), tc, loader,
            data_state_fn=loader.state, data_restore_fn=loader.restore)

    return run_with_restarts(make, fail_at=crash_at)


def test_run_with_restarts_resumes_bit_for_bit(tmp_path):
    """A crash at step 7 and a restart from the newest checkpoint end at
    the same parameters, bit for bit, as a run that never crashed: the
    data cursor rides in the checkpoint, and the CPU's arithmetic is
    deterministic.  Checkpoints are written asynchronously and step 6's
    (or 3's) may not be published yet when the restart looks (as in the
    reference), so the run resumes at a checkpointed step: 6, 3 or 0."""
    whole = _index_run(tmp_path / "a", 10)
    crashed = _index_run(tmp_path / "b", 10, crash_at=7)
    assert whole.step == crashed.step == 10
    resumed_at = crashed.metrics_log[0]["step"] - 1
    assert resumed_at in (0, 3, 6)
    for (n, a), (_, b) in zip(whole.model.named_parameters(),
                              crashed.model.named_parameters()):
        assert torch.equal(a, b), n
    assert sorted(os.listdir(tmp_path / "b"))[-1] == "step_00000010"
    assert [m["loss"] for m in whole.metrics_log[resumed_at:]] == \
        [m["loss"] for m in crashed.metrics_log]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dlrm-rm2"])
def test_launch_train_on_cpu(arch, capsys, tmp_path):
    from repro_torch.launch import train
    trainer = train.main(["--arch", arch, "--steps", "4", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
    assert trainer.step == 4
    out = capsys.readouterr().out
    assert "4 steps in" in out and "on cpu" in out
    assert os.listdir(tmp_path) == ["step_00000002", "step_00000004"] or \
        sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]


def test_launch_train_index_backed_with_crash(capsys, tmp_path):
    from repro_torch.launch import train
    trainer = train.main(["--arch", "yi-9b", "--steps", "8", "--device",
                          "cpu", "--index-backed", "--docs", "40",
                          "--crash-at", "5", "--ckpt-dir", str(tmp_path)])
    assert trainer.step == 8
    assert "pipeline: 40 docs" in capsys.readouterr().out


def test_chip_smoke_lm_training_phases_on_the_cpu():
    """``chip_smoke.py``'s ``train_lm`` at the smoke config (64-token
    windows, chunks of 16) and ``train_small`` on the host: the cursor,
    the falling loss on a repeated batch, and the restart's checks hold."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    cpu = torch.device("cpu")
    row = chip_smoke.phase_train_lm(cpu, smoke=True, seq=64, batch=2,
                                    steps=3, n_docs=12, doc_len=300,
                                    chunk=16)
    assert row["data_state"] == {"cursor": 6, "epoch": 0}
    assert row["repeated_batch_losses"][1] < row["repeated_batch_losses"][0]
    assert row["model_flops_per_step"] > 6 * row["params"] * 128
    small = chip_smoke.phase_train_small(cpu)
    assert small["resumed_at"] in (0, 3, 6) and small["resumed_bit_for_bit"]
