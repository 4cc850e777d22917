"""Recsys training in the port against ``repro.models.recsys``: the
five losses and their gradients at the smoke configs (two-tower with and
without ``loss_chunk``), and ``embedding_bag``'s backward — the plain
version and the autograd Function every lookup goes through — against
``jax.grad`` of ``jnp.take`` and ``recsys._embed_bag``, wrapped and
dropped ids included.

Tolerance: the reference's float32 result against its float64 result
(``jax.enable_x64``, the weights widened); the port's float32 must lie
within RATIO (8) × that spread of the reference's float32, plus one
float32 ulp of the largest entry.  Two-tower's gradients take at least
1.24e-5, the spread between the reference's own chunked and unchunked
losses (ROADMAP §3, fault (b)), and its loss 1e-5 relative, that check's
own tolerance.  The backward's plain version adds a
row's contributions in item order, as ``jax.grad``'s scatter does here,
so on the CPU it is held to 1 ulp of each row's sum of |terms|.
"""

import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from repro.configs import recsys_family as JF  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs import recsys_family as TF  # noqa: E402
from repro_torch.convert import model_tree, recsys_from_jax  # noqa: E402
from repro_torch.dist.checkpoint import tree_leaves  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_backward, embedding_bag_backward_ref,
    embedding_bag_padded)
from repro_torch.kernels.embedding_bag import kernel as bag_kernel  # noqa
from repro_torch.models import recsys as TR  # noqa: E402

RATIO = 8.0
FAULT_B = 1.24e-5
ARCHS = list(JF.RECSYS_SPECS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small ops; with a pool of 8 threads in each of
    the suite's parallel workers they oversubscribe the cores, so the
    module runs torch on one thread (and restores the count after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(ref32, ref64, floor=0.0):
    ref32, ref64 = (np.asarray(x, np.float64) for x in (ref32, ref64))
    return max(RATIO * np.abs(ref32 - ref64).max()
               + np.spacing(np.float32(np.abs(ref64).max())), floor)


def _setup(name, cfg=None, batch=None):
    spec = JF.RECSYS_SPECS[name]
    cfg = cfg or spec.smoke_config
    params = spec.init_fn(cfg, jax.random.PRNGKey(1))
    tcfg = TF.get_config(name, smoke=True)
    tcfg = dataclasses.replace(tcfg, **{f.name: getattr(cfg, f.name)
                                        for f in dataclasses.fields(tcfg)})
    model = recsys_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    batch = batch or TF.smoke_batch(name, "train", seed=4)
    return spec, cfg, params, model, batch


def _compare(name, spec, cfg, params, model, batch, floor=0.0):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = lambda p: spec.loss_fn(p, cfg, jb)           # noqa: E731
    jv, jg = jax.value_and_grad(loss)(params)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        jv64, jg64 = jax.value_and_grad(loss)(p64)
    model.requires_grad_(True)
    tv = TF.loss_fn(name, model, batch)
    tv.backward()
    # two-tower's loss: at least the reference's own chunked-vs-full
    # rtol of 1e-5 (tests/test_perf_paths.py)
    lfloor = 1e-5 * abs(float(jv)) if floor else 0.0
    assert abs(tv.item() - float(jv)) <= _tol(jv, jv64, lfloor), (
        tv.item(), jv)
    got = tree_leaves(model_tree(model, {n: p.grad for n, p in
                                         model.named_parameters()}))
    assert len(got) == len(jax.tree.leaves(jg))
    for g, a, b in zip(got, jax.tree.leaves(jg), jax.tree.leaves(jg64)):
        err = np.abs(g.numpy() - np.asarray(a)).max()
        assert err <= _tol(a, b, floor), (name, g.shape, err)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_reference(name):
    floor = FAULT_B if name == "two-tower-retrieval" else 0.0
    _compare(name, *_setup(name), floor=floor)


@pytest.mark.parametrize("chunk", [0, 16, 32])
def test_twotower_streamed_loss_matches_reference(chunk):
    """64 examples, chunks of 16 and 32: the port's streamed log
    normalizer (recomputed in the backward) against the reference's scan,
    and against its unchunked loss."""
    cfg = JR.TwoTowerConfig(n_users=500, n_items=400, embed_dim=16,
                            tower_mlp=(32, 16), loss_chunk=chunk)
    batch = TF.train_batch("two-tower-retrieval", cfg, batch=64, seed=0)
    _compare("two-tower-retrieval",
             *_setup("two-tower-retrieval", cfg, batch), floor=FAULT_B)


def test_twotower_chunk_must_divide_the_batch():
    cfg = JR.TwoTowerConfig(n_users=50, n_items=40, embed_dim=8,
                            tower_mlp=(8,), loss_chunk=16)
    _, _, _, model, _ = _setup("two-tower-retrieval", cfg)
    batch = TF.train_batch("two-tower-retrieval", cfg, batch=40, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        TF.loss_fn("two-tower-retrieval", model, batch)


def test_bce_with_logits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(64) * 30).astype(np.float32)
    y = (rng.random(64) < 0.3).astype(np.float32)
    ref = float(JR.bce_with_logits(jnp.asarray(x), jnp.asarray(y)))
    got = TR.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(got.item() - ref) <= 4 * np.spacing(np.float32(ref))


def test_train_batch_shapes_match_the_reference_cells():
    for name in ARCHS:
        cfg = TF.get_config(name, smoke=True)
        cells = JF.RECSYS_SPECS[name].cells(
            JF.RECSYS_SPECS[name].smoke_config)["train_batch"].batch_specs
        b = TF.train_batch(name, cfg, batch=32, seed=1)
        for k, spec in cells.items():
            assert b[k].shape == (32,) + tuple(spec.shape[1:]), (name, k)
            assert b[k].dtype == spec.dtype, (name, k)


# ------------------------------------------------------------------ #
# embedding_bag's backward
# ------------------------------------------------------------------ #
def _bag_inputs(v, d, b, l, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(dtype)
    ids = rng.integers(-v, v, (b, l)).astype(np.int32)
    ids[0, 0] = v + 3            # dropped (NaN row in the forward)
    ids[-1, -1] = -v - 1         # dropped
    ids[1 % b, :] = 2            # one row named l times in one bag
    w = rng.standard_normal((b, l)).astype(np.float32)
    w[:, -1] = 0.0               # padding
    g = rng.standard_normal((b, d)).astype(dtype)
    return table, ids, w, g


def _jax_grad(table, ids, w, g):
    def f(t):
        return jnp.sum(JR._embed_bag(t, jnp.asarray(ids), jnp.asarray(w))
                       * jnp.asarray(g))
    return np.asarray(jax.grad(f)(jnp.asarray(table)))


def _row_bound(ids, w, g, v):
    """Per element: 1 ulp of the row's sum of |w · g| (the order of the
    additions is the only difference)."""
    bound = np.zeros((v, g.shape[1]))
    for (bi, li), i in np.ndenumerate(ids):
        if -v <= i < v and w[bi, li] != 0:
            bound[i % v] += np.abs(w[bi, li] * g[bi].astype(np.float64))
    return bound * 2.0 ** -23 + np.finfo(np.float32).tiny


@pytest.mark.parametrize("v,d,b,l", [(50, 16, 8, 5), (20, 10, 12, 3),
                                     (7, 64, 40, 1), (300, 256, 6, 8)])
def test_backward_ref_matches_jax_grad(v, d, b, l):
    table, ids, w, g = _bag_inputs(v, d, b, l, seed=v + d)
    want = _jax_grad(table, ids, w, g)
    got = embedding_bag_backward_ref(torch.from_numpy(g),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(w), v)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    assert (np.abs(got.numpy() - want) <= _row_bound(ids, w, g, v)).all()


def test_function_gradient_matches_jax_and_counts_no_launch_on_cpu():
    v, d, b, l = 40, 12, 16, 4
    table, ids, w, g = _bag_inputs(v, d, b, l, seed=9)
    t = torch.from_numpy(table).requires_grad_(True)
    bag_kernel.launches = bag_kernel.backward_launches = 0
    out = embedding_bag_padded(t, torch.from_numpy(ids), torch.from_numpy(w))
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.isnan(out[0]).all()              # the dropped id's NaN row
    want = _jax_grad(table, ids, w, g)
    assert np.isfinite(t.grad.numpy()).all()
    assert (np.abs(t.grad.numpy() - want) <= _row_bound(ids, w, g, v)).all()
    # the CPU takes the plain versions: no kernel launch is counted
    assert bag_kernel.launches == bag_kernel.backward_launches == 0


def test_function_bf16_accumulates_in_float32_and_casts_once():
    v, d, b, l = 30, 16, 64, 4
    table, ids, w, g = _bag_inputs(v, d, b, l, seed=3)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got = embedding_bag_backward(gb, torch.from_numpy(ids),
                                 torch.from_numpy(w), v)
    want = embedding_bag_backward_ref(gb.float(), torch.from_numpy(ids),
                                      torch.from_numpy(w), v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_function_refuses_trainable_weights_and_gives_none():
    t = torch.zeros(5, 3, requires_grad=True)
    ids = torch.zeros((2, 2), dtype=torch.int32)
    w = torch.ones((2, 2), requires_grad=True)
    with pytest.raises(ValueError, match="weights"):
        embedding_bag_padded(t, ids, w)
    out = embedding_bag_padded(t, ids, w.detach())
    out.sum().backward()
    assert t.grad[0].tolist() == [4.0, 4.0, 4.0]


def test_backward_wrapper_checks():
    g = torch.zeros((2, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="bags"):
        embedding_bag_backward(torch.zeros((3, 4)), ids, w, 5)
    with pytest.raises(TypeError):
        embedding_bag_backward(g.half(), ids, w, 5)
    with pytest.raises(TypeError):
        embedding_bag_backward(g, ids.long(), w, 5)
    with pytest.raises(ValueError, match="no rows"):
        embedding_bag_backward(g, ids, w, 0)
    assert embedding_bag_backward(torch.zeros((0, 4)), ids[:0], w[:0],
                                  5).abs().sum() == 0


@pytest.mark.parametrize("n,d,elt,aligned", [
    (65536 * 26, 64, 4, True), (65536 * 8, 256, 4, True), (10, 10, 4, True),
    (3, 64, 2, True), (100, 64, 4, False), (0, 16, 4, True),
    (7, 1, 4, True), (5, 1000, 2, True)])
def test_backward_plan_covers_every_item(n, d, elt, aligned):
    p = bag_kernel.backward_plan(n, d, elt, aligned, 132)
    vec = 16 // elt if aligned and d * elt % 16 == 0 else 1
    assert p.vec == vec
    vectors = -(-d // vec)
    assert p.lanes & (p.lanes - 1) == 0 and 1 <= p.lanes <= 32
    assert p.lanes >= min(vectors, 32)
    assert p.lanes == 32 or p.lanes < 2 * vectors
    assert 1 <= p.grid <= 132 * bag_kernel.BACKWARD_BLOCKS_PER_SM
    # a grid-stride walk: each item has exactly one (warp, group) slot
    groups = 32 // p.lanes * bag_kernel.WARPS * p.grid
    assert groups > 0


# ------------------------------------------------------------------ #
# chip_smoke.py's training phases, on the CPU
# ------------------------------------------------------------------ #
import chip_smoke  # noqa: E402  (the repository root's card script)


def test_chip_smoke_bag_backward_small_on_the_cpu():
    assert chip_smoke.phase_bag_backward_small(torch.device("cpu")) == 0.0


def test_bag_backward_bound_refuses_a_wrong_gradient():
    """The per-element bound passes the plain version and refuses a
    gradient whose one element moved by 1e-4 of its row's scale, and one
    that counts a dropped id."""
    g, idx, w = chip_smoke.bag_backward_case(*chip_smoke.BAG_BACKWARD_CASES[1])
    v = chip_smoke.BAG_BACKWARD_CASES[1][1]
    want = embedding_bag_backward_ref(g, idx, w, v)
    bound = chip_smoke.bag_backward_bound(g, idx, w, v)
    assert chip_smoke.bag_backward_close(want, want, bound)[2]
    bad = want.clone()
    r, c = divmod(int(want.abs().argmax()), want.shape[1])
    bad[r, c] += 1e-4 * want[r].abs().max()
    assert not chip_smoke.bag_backward_close(bad, want, bound)[2]
    ids = idx.long()
    wrapped = torch.where(ids >= v, ids - v, ids).to(torch.int32)   # keep
    kept = embedding_bag_backward_ref(g, wrapped, w, v)
    assert not chip_smoke.bag_backward_close(kept, want, bound)[2]


def test_chip_smoke_train_recsys_on_the_cpu():
    out = chip_smoke.phase_train_recsys(torch.device("cpu"), smoke=True,
                                        batch=64)
    for name in ("dlrm-rm2", "two-tower-retrieval"):
        row = out[name]
        assert row["launches"] == row["backward_launches"] == 0
        assert row["losses"][-1] < row["losses"][0]
        assert len(row["lookups"]) == chip_smoke.TRAIN_LAUNCHES[name]
        assert all(k["forward_bit_for_bit"] for k in row["lookups"])
    assert [k["shape"] for k in out["two-tower-retrieval"]["lookups"]] == \
        [[64, 1], [64, 8], [64, 1]]
    assert set(out["smoke_card_vs_host"]) == set(chip_smoke.RECSYS_ARCHS)


@pytest.mark.parametrize("name", ["dlrm-rm2", "two-tower-retrieval"])
def test_chip_smoke_check_lookups_refuses_a_wrong_backward(name,
                                                           monkeypatch):
    """Phase 19's check of one step's lookups passes the plain versions and
    refuses a backward that moves one element by a thousandth of its
    row."""
    bag = sys.modules["repro_torch.kernels.embedding_bag"]
    cfg = TF.get_config(name, smoke=True)
    model = TR.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    model.requires_grad_(True)
    batch = TF.train_batch(name, cfg, 32, seed=4)
    rows = chip_smoke.check_lookups(name, model, batch)
    assert len(rows) == chip_smoke.TRAIN_LAUNCHES[name]
    right = bag.embedding_bag_backward

    def wrong(g, ids, w, v):
        out = right(g, ids, w, v)
        r = int(ids.reshape(-1)[0]) % v
        out[r, 0] += 1e-3 * out[r].abs().max() + 1e-6
        return out
    monkeypatch.setattr(bag, "embedding_bag_backward", wrong)
    with pytest.raises(AssertionError, match="backward kernel"):
        chip_smoke.check_lookups(name, model, batch)


def test_params_close_refuses_a_moved_parameter():
    """Phase 19's comparison passes the host's own run and refuses one
    whose single coordinate moved by more than two AdamW steps can."""
    cfg = TF.get_config("dlrm-rm2", smoke=True)
    batch = TF.smoke_batch("dlrm-rm2", "train", seed=2)

    def make(dev):
        m = TR.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        return chip_smoke.recsys_trainer("dlrm-rm2", cfg, m, batch, 1)
    ref32, ref64 = chip_smoke.host_runs(make)
    chip_smoke.params_close(ref32, ref32, ref64, 1e-3, 1)
    bad = {n: t.clone() for n, t in ref32.items()}
    bad["bot.0.w"][0, 0] += 0.02
    with pytest.raises(AssertionError, match="bot.0.w"):
        chip_smoke.params_close(bad, ref32, ref64, 1e-3, 1)


def test_chip_smoke_bag_backward_deploy_cases_on_the_cpu():
    """Phase 20's inputs at the smoke configs: the plain version equals
    the library's gradient within the bound, the bytes count each
    distinct row named twice, and the history bags' uniform twin has
    their shape and names more distinct rows."""
    import torch.nn.functional as F
    cases = chip_smoke.bag_backward_deploy_cases(torch.device("cpu"),
                                                 batch=256, smoke=True)
    assert set(cases) == {"dlrm", "two_tower_hist"}
    assert cases["dlrm"][4] is None
    _, zipf, w, v, uniform = cases["two_tower_hist"]
    assert uniform.shape == zipf.shape and uniform.dtype == torch.int32
    assert 0 <= int(uniform.min()) and int(uniform.max()) < v
    assert chip_smoke.bag_backward_bytes(w[:, :1], uniform, w)[1] > \
        chip_smoke.bag_backward_bytes(w[:, :1], zipf, w)[1]
    for case, (g, ids, w, v, _) in cases.items():
        got = embedding_bag_backward_ref(g, ids, w, v)
        table = torch.zeros((v, g.shape[1]), requires_grad=True)
        out = F.embedding_bag(ids.long(), table, mode="sum",
                              per_sample_weights=w)
        lib = torch.autograd.grad(out, table, g)[0]
        bound = chip_smoke.bag_backward_bound(g, ids, w, v)
        assert chip_smoke.bag_backward_close(lib, got, bound)[2], case
        nbytes, rows = chip_smoke.bag_backward_bytes(g, ids, w)
        named = ids.reshape(-1)[w.reshape(-1) != 0]
        assert rows == len(torch.unique(named)) < ids.numel()
        assert nbytes == 4 * g.numel() + 8 * ids.numel() + \
            2 * rows * g.shape[1] * 4
