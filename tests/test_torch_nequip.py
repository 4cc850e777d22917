"""NequIP in the port against ``repro.models.nequip``: the graph
generators and the neighbour sampler bit for bit, the weights carried
across bit for bit, ``apply``, ``classify``, ``energy_fn`` and
``energy_and_forces``, ``loss_fn``'s gradients for both tasks against
``jax.grad``, equivariance, a self loop's finite gradient, 3 ``Trainer``
steps against the reference's, the launcher, and ``chip_smoke.py``'s
phases ``gnn_small`` and ``gnn_serve`` on the CPU at smoke sizes.

Tolerance: the reference's float32 result against its float64 result;
the port's float32 must lie within RATIO (8) × that spread of the
reference's float32, plus one float32 ulp of the largest entry.  The
reference cannot run under ``jax.enable_x64`` with its weights widened
(ROADMAP §3, fault (v)): its ``scan`` carries h1 and h2, which start in
the config's dtype (``jnp_dtype`` is float32 for any dtype but bfloat16)
and come out float64.  Its float64 run therefore takes a config whose
``jnp_dtype`` is float64 (a subclass made here; the reference's code
runs unchanged), which widens h1, h2, the edge directions and the radial
basis as well.
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

import chip_smoke  # noqa: E402  (the repository root's card script)
from repro.configs import get_arch  # noqa: E402
from repro.configs import gnn_family as JG  # noqa: E402
from repro.data import synth as JS  # noqa: E402
from repro.models import nequip as JNQ  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import gnn_family as TG  # noqa: E402
from repro_torch.convert import model_tree, nequip_from_jax  # noqa: E402
from repro_torch.data import synth as TS  # noqa: E402
from repro_torch.dist.checkpoint import tree_leaves  # noqa: E402
from repro_torch.models import nequip as TNQ  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

RATIO = 8.0
STEPS = 3
FLIP_STEP = 2.5          # the most one AdamW step moves a coordinate, in lr
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SMOKE = TG.NEQUIP_SMOKE
MOLECULE = TG.cfg_for_cell(SMOKE, "molecule")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small ops; with a pool of 8 threads in each of
    the suite's parallel workers they oversubscribe the cores, so the
    module runs torch on one thread (and restores the count after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class _Wide(JNQ.NequipConfig):
    """The reference's config with float64 as its working dtype."""

    @property
    def jnp_dtype(self):
        return jnp.float64


def _wide(cfg):
    return _Wide(**{f.name: getattr(cfg, f.name)
                    for f in dataclasses.fields(JNQ.NequipConfig)})


def _jcfg(cfg):
    """The reference's config with the port config's fields."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return JNQ.NequipConfig(**fields)


def _setup(cfg, seed=0):
    jcfg = _jcfg(cfg)
    params = JNQ.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, params, nequip_from_jax(np_params, cfg, "cpu")


def _both(fn_ref, fn_port, params, model, jcfg):
    """(port float32, reference float32, reference float64) as float64
    numpy arrays."""
    ref = jax.jit(fn_ref, static_argnums=(1, 2))     # one compile a dtype
    r32 = ref(params, jcfg, jnp.float32)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                           params)
        r64 = ref(p64, _wide(jcfg), jnp.float64)
    got = fn_port(model)
    as64 = lambda t: jax.tree.map(                       # noqa: E731
        lambda x: np.asarray(x.detach().numpy() if isinstance(
            x, torch.Tensor) else x, np.float64), t)
    return as64(got), as64(r32), as64(r64)


def _tol(ref32, ref64):
    return (RATIO * np.abs(ref32 - ref64).max()
            + np.spacing(np.float32(np.abs(ref64).max())))


def _assert_close(got, ref32, ref64, what=""):
    for g, a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref32),
                       jax.tree.leaves(ref64)):
        assert g.shape == a.shape, (what, g.shape, a.shape)
        err = np.abs(g - a).max() if g.size else 0.0
        assert err <= _tol(a, b), (what, g.shape, err, _tol(a, b))


def _graph(seed=3, n=40, e=160, cfg=SMOKE):
    return JS.random_graph(seed, n, e, d_feat=cfg.d_feat,
                           n_classes=cfg.n_classes)


def _molecules(seed=4, batch=3, n=7, e=18):
    return JS.molecule_batch(seed, batch=batch, n_nodes=n, n_edges=e)


def _jx(b, dt):
    return {k: (v if np.isscalar(v) else
                jnp.asarray(v, dt) if v.dtype.kind == "f" else jnp.asarray(v))
            for k, v in b.items()}


def _tx(b):
    return {k: v if np.isscalar(v) else torch.from_numpy(np.asarray(v))
            for k, v in b.items()}


# ------------------------------------------------------------------ #
# synth
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("d_feat,n_classes", [(0, 0), (16, 5), (602, 41)])
def test_random_graph_bit_for_bit(d_feat, n_classes):
    want = JS.random_graph(7, 300, 2000, d_feat=d_feat, n_classes=n_classes)
    got = TS.random_graph(7, 300, 2000, d_feat=d_feat, n_classes=n_classes)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_molecule_batch_bit_for_bit():
    want, got = JS.molecule_batch(5, 6, 9, 20), TS.molecule_batch(5, 6, 9, 20)
    assert sorted(got) == sorted(want) and got["n_graphs"] == 6
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("fanouts", [[5, 3], [15, 10]])
def test_neighbor_sampler_bit_for_bit(fanouts):
    """The same graph, seeds and generator state give the same subgraph,
    isolated nodes (self loops) included."""
    g = JS.random_graph(0, 500, 1500)
    seeds = np.random.default_rng(1).choice(500, 32, replace=False)
    want = JS.NeighborSampler(500, g["senders"], g["receivers"]).sample(
        seeds, fanouts, np.random.default_rng(2))
    got = TS.NeighborSampler(500, g["senders"], g["receivers"]).sample(
        seeds, fanouts, np.random.default_rng(2))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.all(got["nodes"][got["seed_local"]] == seeds)


# ------------------------------------------------------------------ #
# configs and weights
# ------------------------------------------------------------------ #
def test_configs_equal_jax_field_by_field():
    """Every field the port keeps equals the reference's (``scan_unroll``
    is JAX's); the cells' shapes and ``cfg_for_cell`` agree."""
    for port, ref in ((TG.NEQUIP, JG.NEQUIP), (SMOKE, JG.NEQUIP_SMOKE)):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
        for cell in TG.SHAPES:
            a, b = TG.cfg_for_cell(port, cell), JG.cfg_for_cell(ref, cell)
            assert (a.d_feat, a.n_classes) == (b.d_feat, b.n_classes)
    assert TG.SHAPES == JG.SHAPES
    assert TG.get_config("nequip") is TG.NEQUIP
    assert TG.get_config("nequip", smoke=True) is SMOKE
    with pytest.raises(KeyError):
        TG.get_config("gin")


@pytest.mark.parametrize("seed", [0, 1])
def test_smoke_batch_is_the_reference_s(seed):
    for cfg in (SMOKE, MOLECULE):
        want = JG.gnn_smoke_batch(_jcfg(cfg), "train", seed)
        got = TG.gnn_smoke_batch(cfg, "train", seed)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [SMOKE, MOLECULE], ids=["classify",
                                                        "molecule"])
def test_convert_bit_for_bit(cfg, dtype):
    cfg = dataclasses.replace(cfg, dtype=dtype)
    _, params, model = _setup(cfg, seed=2)
    got = tree_leaves(model_tree(model))
    want = jax.tree.leaves(jax.tree.map(np.asarray, params))
    assert len(got) == len(want) == len(list(model.parameters()))
    view = np.int16 if dtype == "bfloat16" else np.int32
    tview = torch.int16 if dtype == "bfloat16" else torch.int32
    for g, w in zip(got, want):
        assert g.dtype == cfg.torch_dtype and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.contiguous().view(tview).numpy(),
                                      np.ascontiguousarray(w).view(view))


def test_convert_refuses_mismatched_params():
    _, params, _ = _setup(SMOKE)
    np_params = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="do not match"):
        nequip_from_jax(np_params, MOLECULE)            # no feat_embed
    with pytest.raises(ValueError, match="config needs"):
        nequip_from_jax(np_params, dataclasses.replace(SMOKE, n_layers=3))


def test_init_params_matches_jax_distribution():
    """Each leaf's scale: N(0, 1/shape[0]) a matrix (a stacked layer leaf
    by its own first axis), the species embedding N(0, 1)."""
    cfg = dataclasses.replace(TG.NEQUIP, d_feat=602, n_classes=41)
    model = TNQ.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, p in model.named_parameters():
        fan_in = 1 if name == "species_embed" else p.shape[-2]
        std = float(p.float().std()) * np.sqrt(fan_in)
        assert 0.75 < std < 1.25, (name, std)


# ------------------------------------------------------------------ #
# the model's functions
# ------------------------------------------------------------------ #
def test_bessel_rbf_and_sym_traceless():
    r = np.array([1e-12, 0.3, 2.0, 4.999, 5.0, 7.0], np.float32)
    want = np.asarray(JNQ.bessel_rbf(jnp.asarray(r), 8, 5.0))
    got = TNQ.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    m = np.random.default_rng(0).standard_normal((4, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(TNQ._sym_traceless(torch.from_numpy(m)),
                               np.asarray(JNQ._sym_traceless(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)


def test_apply_and_classify_match_reference():
    jcfg, params, model = _setup(SMOKE, seed=1)
    b = _graph()
    args = ("positions", "species", "senders", "receivers")

    def ref(p, c, dt):
        jb = _jx(b, dt)
        return (JNQ.apply(p, c, *(jb[k] for k in args), jb["node_feats"]),
                JNQ.classify(p, c, *(jb[k] for k in args),
                             jb["node_feats"]))

    def port(m):
        tb = _tx(b)
        return (TNQ.apply(m, *(tb[k] for k in args), tb["node_feats"]),
                TNQ.classify(m, *(tb[k] for k in args), tb["node_feats"]))
    _assert_close(*_both(ref, port, params, model, jcfg), "classify")


def test_energy_and_forces_match_reference():
    jcfg, params, model = _setup(MOLECULE, seed=1)
    b = _molecules()
    args = ("positions", "species", "senders", "receivers", "graph_ids")

    def ref(p, c, dt):
        jb = _jx(b, dt)
        one = JNQ.energy_fn(p, c, *(jb[k] for k in args[:4]))
        return (one, JNQ.energy_fn(p, c, *(jb[k] for k in args), 3),
                *JNQ.energy_and_forces(p, c, *(jb[k] for k in args), 3))

    def port(m):
        tb = _tx(b)
        return (TNQ.energy_fn(m, *(tb[k] for k in args[:4])),
                TNQ.energy_fn(m, *(tb[k] for k in args), 3),
                *TNQ.energy_and_forces(m, *(tb[k] for k in args), 3))
    got, r32, r64 = _both(ref, port, params, model, jcfg)
    assert got[0].shape == (1,) and got[1].shape == (3,)
    _assert_close(got, r32, r64, "energy and forces")


@pytest.mark.parametrize("task", ["classify", "molecule"])
def test_loss_gradients_match_jax_grad(task):
    """``loss_fn`` and its gradients for both tasks; the molecule loss
    differentiates the forces again (``create_graph``)."""
    cfg = SMOKE if task == "classify" else MOLECULE
    jcfg, params, model = _setup(cfg, seed=3)
    b = _graph(seed=5) if task == "classify" else _molecules(seed=6)

    def ref(p, c, dt):
        return jax.value_and_grad(lambda q: JNQ.loss_fn(q, c, _jx(b, dt)))(p)

    def port(m):
        m.requires_grad_(True)
        loss = TNQ.loss_fn(m, _tx(b))
        loss.backward()
        return loss, model_tree(m, {n: p.grad for n, p in
                                    m.named_parameters()})
    (gl, gg), (l32, g32), (l64, g64) = _both(ref, port, params, model, jcfg)
    _assert_close(gl, l32, l64, "loss")
    got = [np.asarray(x) for x in tree_leaves(gg)]
    assert len(got) == len(jax.tree.leaves(g32))
    _assert_close(got, jax.tree.leaves(g32), jax.tree.leaves(g64), task)


def test_bfloat16_classify_matches_reference():
    """The bfloat16 option: the port in bfloat16 within RATIO × the
    reference's own bfloat16-vs-float32 distance (both round at their own
    places) plus a bfloat16 ulp."""
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    jcfg, params, model = _setup(cfg, seed=1)
    b = _graph()
    args = ("positions", "species", "senders", "receivers", "node_feats")
    want = np.asarray(JNQ.classify(params, jcfg, *(jnp.asarray(b[k])
                                                   for k in args)),
                      np.float64)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    want32 = np.asarray(JNQ.classify(p32, _jcfg(SMOKE), *(jnp.asarray(b[k])
                                                          for k in args)))
    got = TNQ.classify(model, *(_tx(b)[k] for k in args))
    assert got.dtype == torch.bfloat16
    tol = RATIO * np.abs(want - want32).max() + np.abs(want).max() * 2.0 ** -8
    assert np.abs(got.double().numpy() - want).max() <= tol


# ------------------------------------------------------------------ #
# equivariance and the safe norm
# ------------------------------------------------------------------ #
def test_equivariance():
    """E and the node logits invariant, F equivariant under a rotation (the
    reference's test, with its tolerances)."""
    model = TNQ.init_params(MOLECULE, torch.Generator().manual_seed(1), "cpu")
    b = _tx(_molecules(seed=0, batch=2, n=6, e=14))
    args = (b["species"], b["senders"], b["receivers"], b["graph_ids"], 2)
    rot = torch.from_numpy(chip_smoke.gnn_rotation().astype(np.float32))
    e0, f0 = TNQ.energy_and_forces(model, b["positions"], *args)
    e1, f1 = TNQ.energy_and_forces(model, b["positions"] @ rot.T, *args)
    torch.testing.assert_close(e0, e1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(f0 @ rot.T, f1, rtol=1e-3, atol=1e-4)
    cls = TNQ.init_params(SMOKE, torch.Generator().manual_seed(1), "cpu")
    g = _tx(_graph())
    gargs = (g["species"], g["senders"], g["receivers"], g["node_feats"])
    torch.testing.assert_close(
        TNQ.classify(cls, g["positions"], *gargs),
        TNQ.classify(cls, g["positions"] @ rot.T, *gargs),
        rtol=1e-4, atol=1e-4)


def test_self_loop_gives_finite_forces_and_gradients():
    """A zero-length edge (a self loop, or padding) contributes nothing:
    finite forces and parameter gradients, equal to the reference's."""
    jcfg, params, model = _setup(MOLECULE, seed=2)
    b = chip_smoke.gnn_self_loop(_molecules(seed=7))
    assert b["senders"][0] == b["receivers"][0]
    args = ("positions", "species", "senders", "receivers", "graph_ids")
    e, f = TNQ.energy_and_forces(model, *(_tx(b)[k] for k in args), 3)
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(e).all())
    je, jf = JNQ.energy_and_forces(params, jcfg, *(_jx(b, jnp.float32)[k]
                                                   for k in args), 3)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-5)
    model.requires_grad_(True)
    TNQ.loss_fn(model, _tx(b)).backward()
    for n, p in model.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), n


# ------------------------------------------------------------------ #
# training
# ------------------------------------------------------------------ #
def _ref_run(cfg, params, batches):
    tc = JTR.TrainerConfig(total_steps=STEPS, ckpt_every=100, log_every=1,
                           opt=JO.AdamWConfig(**OPT))
    t = JTR.Trainer(lambda p, b: JNQ.loss_fn(p, cfg, b), params, tc,
                    iter(batches))
    t.train()
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(t.params)]


@pytest.mark.parametrize("cfg", [SMOKE, MOLECULE], ids=["classify",
                                                        "molecule"])
def test_trainer_steps_match_reference(cfg):
    """3 steps of the port's ``Trainer`` against 3 of the reference's from
    the same converted init on the smoke batches at consecutive seeds,
    each parameter within RATIO × the reference's float32-vs-float64
    spread (mean a leaf), and each element within that or what two AdamW
    runs that move a coordinate in opposite directions can differ by."""
    jcfg, params, model = _setup(cfg, seed=0)
    np_params = jax.tree.map(np.array, params)
    batches = [TG.gnn_smoke_batch(cfg, "train", seed=s) for s in range(STEPS)]
    jbatches = [{k: v if np.isscalar(v) else jnp.asarray(v)
                 for k, v in b.items()} for b in batches]
    ref32 = _ref_run(jcfg, jax.tree.map(jnp.asarray, np_params), jbatches)
    with jax.enable_x64(True):
        ref64 = _ref_run(_wide(jcfg), jax.tree.map(
            lambda x: jnp.asarray(x, jnp.float64), np_params), jbatches)
    tc = TTR.TrainerConfig(total_steps=STEPS, ckpt_every=100, log_every=1,
                           opt=TO.AdamWConfig(**OPT))
    out = TTR.Trainer(TG.loss_fn, model, tc, iter(batches)).train()
    assert out["step"] == STEPS and len(out["metrics"]) == STEPS
    got = tree_leaves(model_tree(model))
    assert len(got) == len(ref32)
    flip = 2 * FLIP_STEP * OPT["lr"] * STEPS
    for g, a, b in zip(got, ref32, ref64):
        d = np.abs(g.detach().double().numpy() - a)
        spread = np.abs(a - b)
        ulp = np.spacing(np.float32(np.abs(a).max()))
        assert d.mean() <= RATIO * spread.mean() + ulp, (g.shape, d.mean())
        assert d.max() <= max(RATIO * spread.max() + ulp, flip), (
            g.shape, d.max(), spread.max())


def test_launch_train_on_cpu(capsys):
    from repro_torch.launch import train
    trainer = train.main(["--arch", "nequip", "--steps", "4", "--device",
                          "cpu"])
    out = capsys.readouterr().out
    assert trainer.step == 4
    assert "nequip (smoke config nequip-smoke) on cpu" in out
    assert all(np.isfinite(m["loss"]) for m in trainer.metrics_log)
    assert get_arch("nequip").smoke_config.n_classes == SMOKE.n_classes


# ------------------------------------------------------------------ #
# chip_smoke.py's phases on the CPU
# ------------------------------------------------------------------ #
def test_chip_smoke_gnn_small_on_the_cpu():
    """Phase ``gnn_small`` with the CPU as both devices: every check holds
    (equal outputs and gradients, rotations within the host's rule)."""
    out = chip_smoke.phase_gnn_small(torch.device("cpu"))
    assert set(out) == {"classify", "energy_and_forces"}
    for task in out.values():
        assert all(v == 0.0 for v in task["loss_grads"].values())


def test_chip_smoke_gnn_serve_on_the_cpu():
    """Phase ``gnn_serve`` at the full config on small graphs: a parent of
    3,000 nodes at mean degree 50, 64 seeds at fanout 15-10, and 6
    molecules."""
    out = chip_smoke.phase_gnn_serve(torch.device("cpu"),
                                     parent=(3_000, 150_000), seeds=64,
                                     molecules=(6, 30, 64), timed=1)
    mb, mol = out["minibatch_lg"], out["molecule"]
    assert mb["n_classes"] == 41 and mb["d_feat"] == 602
    assert 64 * 15 < mb["edges"] <= 64 * 15 + 64 * 15 * 10
    assert mol["nodes"] == 6 * 30 and mol["edges"] == 6 * 64
    for row in (mb, mol):
        assert all(c.get("ok", True) for c in row["checks"].values())


def test_chip_smoke_gnn_check_refuses_a_wrong_force(monkeypatch):
    """A card whose forces on the rotated input come back with the wrong
    sign (forces that do not rotate) fails ``gnn_check``."""
    model = TNQ.init_params(MOLECULE, torch.Generator().manual_seed(0),
                            "cpu")
    b = _molecules(seed=8)
    real = chip_smoke.gnn_call
    calls = []

    def wrong(m, task, tb):
        out = real(m, task, tb)
        calls.append(1)
        if len(calls) == 4:                  # the card's rotated call
            out["forces"] = -out["forces"]
        return out
    monkeypatch.setattr(chip_smoke, "gnn_call", wrong)
    with pytest.raises(AssertionError, match="forces"):
        chip_smoke.gnn_check(torch.device("cpu"), model,
                             "energy_and_forces", b,
                             chip_smoke.gnn_rotation(), "probe")
