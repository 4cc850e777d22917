"""The port's AdamW (``repro_torch.train.optimizer``) against
``repro.train.optimizer``.

Given the same scalars (clip scale, learning rate, bias corrections) a
leaf's update is the reference's operation for operation, so it must
agree bit for bit, on float32 and bfloat16 leaves.  The scalars are
float32 tensors on both sides, but XLA's float32 ``cos`` and ``pow`` and
PyTorch's (glibc's) round differently in the last place (measured here:
each wrong in some of 3,000 steps against the correctly rounded value),
and the gradient norm's sum runs in another order: those are held to one
float32 ulp and 1e-6 relative, and the whole step to what one ulp of the
learning rate and scale can move (the schedule: 2 ulps, one of cos
carried through its sums and products).
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import optimizer as JO  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

CFG = JO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=200,
                     weight_decay=0.05, grad_clip=1.0)
TCFG = TO.AdamWConfig(**dataclasses.asdict(CFG))


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def test_config_fields_equal_reference():
    assert dataclasses.asdict(TO.AdamWConfig()) == \
        dataclasses.asdict(JO.AdamWConfig())


def test_lr_schedule_within_one_ulp_and_exact_in_warmup():
    steps = np.arange(0, 260, dtype=np.int32)
    ref = np.asarray([JO.lr_schedule(CFG, jnp.int32(s)) for s in steps])
    got = np.asarray([TO.lr_schedule(TCFG, torch.tensor(int(s),
                                                        dtype=torch.int32))
                      .item() for s in steps], np.float32)
    assert got.dtype == ref.dtype == np.float32
    assert _ulps(got, ref).max() <= 2.0   # cos's ulp, through 3 products
    warm = steps < CFG.warmup_steps       # no cos: bit for bit
    assert got[warm].tobytes() == ref[warm].tobytes()
    assert (got == ref).mean() > 0.9


def _tree(rng, dtype=np.float32):
    shapes = {"a": (7, 5), "b": (33,), "c": (4, 3, 2)}
    return {k: rng.standard_normal(s).astype(dtype) for k, s in
            shapes.items()}


def _ref_scalars(cfg, grads, step):
    """The reference's scalars of step ``step`` (1-based), as its
    ``adamw_update`` computes them."""
    stepj = jnp.int32(step)
    gn = JO.global_norm(grads)
    scale = jnp.minimum(1.0, cfg.grad_clip / jnp.maximum(gn, 1e-9))
    lr = JO.lr_schedule(cfg, stepj)
    bc1 = 1 - cfg.b1 ** stepj.astype(jnp.float32)
    bc2 = 1 - cfg.b2 ** stepj.astype(jnp.float32)
    return [torch.tensor(np.asarray(x)) for x in (scale, lr, bc1, bc2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_leaf_update_bit_for_bit_given_the_scalars(dtype, grad_scale):
    """Five steps of ``_update_leaf`` with the reference's scalars equal
    the reference's ``adamw_update`` bit for bit: parameters, mu and nu
    (bfloat16 parameters with float32 moments)."""
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {k: jnp.asarray(v, jdt) for k, v in _tree(rng).items()}
    state = JO.init_opt_state(params)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in params.items()}
    mu = {k: torch.zeros(v.shape) for k, v in tp.items()}
    nu = {k: torch.zeros(v.shape) for k, v in tp.items()}
    for step in range(1, 6):
        g = {k: (rng.standard_normal(v.shape) * grad_scale).astype(
            np.float32) for k, v in tp.items()}
        gj = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        scalars = _ref_scalars(CFG, gj, step)
        params, state, _ = JO.adamw_update(CFG, params, gj, state)
        for k in tp:
            gt = torch.from_numpy(np.array(gj[k].astype(jnp.float32))).to(
                tp[k].dtype)
            TO._update_leaf(TCFG, tp[k], gt, mu[k], nu[k], *scalars)
            want = np.asarray(params[k].astype(jnp.float32))
            assert tp[k].float().numpy().tobytes() == want.tobytes(), (
                step, k)
            assert mu[k].numpy().tobytes() == \
                np.asarray(state["mu"][k]).tobytes()
            assert nu[k].numpy().tobytes() == \
                np.asarray(state["nu"][k]).tobytes()
    assert all(m.dtype == torch.float32 for m in mu.values())


def test_global_norm_close():
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    ref = float(JO.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = TO.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert abs(got.item() - ref) <= 1e-6 * ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_steps_match_reference(dtype):
    """Twenty whole steps of ``adamw_update`` (the clip binding in some):
    the moments and parameters stay within what one float32 ulp of the
    scalars moves (2 ulps of a float32 parameter, 1 of a bfloat16 one),
    and ``step``, ``grad_norm`` and ``lr`` agree."""
    rng = np.random.default_rng(7)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {k: jnp.asarray(v, jdt) for k, v in _tree(rng).items()}
    state = JO.init_opt_state(params)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in params.items()}
    tstate = TO.init_opt_state(_Module(tp))
    for step in range(20):
        g = {k: (rng.standard_normal(v.shape) * (0.03 if step % 2 else 3.0)
                 ).astype(np.float32) for k, v in tp.items()}
        gj = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        params, state, jm = JO.adamw_update(CFG, params, gj, state)
        tm = TO.adamw_update(TCFG, tp, {k: torch.from_numpy(np.array(
            gj[k].astype(jnp.float32))).to(tp[k].dtype) for k in tp}, tstate)
        assert int(tstate["step"]) == int(state["step"]) == step + 1
        assert _ulps(tm["lr"].numpy(), jm["lr"]) <= 1
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for k in tp:
            want = np.asarray(params[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            if dtype == "bfloat16":
                ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
                assert (np.abs(got - want) <= ulp).all(), (step, k)
            else:
                assert _ulps(got, want).max() <= 2, (step, k)
            # the clip scale's ulp moves mu by 2^-23 of its terms
            want_mu = np.asarray(state["mu"][k])
            np.testing.assert_allclose(
                tstate["mu"][k].numpy(), want_mu, rtol=1e-6,
                atol=2.0 ** -21 * np.abs(want_mu).max())


class _Module(torch.nn.Module):
    """Parameters by name, as ``init_opt_state`` reads them."""

    def __init__(self, tensors):
        super().__init__()
        for k, v in tensors.items():
            self.register_parameter(k, torch.nn.Parameter(
                v, requires_grad=False))


def test_init_opt_state_float32_moments_and_int32_step():
    m = _Module({"w": torch.zeros(3, 2, dtype=torch.bfloat16)})
    st = TO.init_opt_state(m, compress_grads=True)
    assert st["mu"]["w"].dtype == st["nu"]["w"].dtype == torch.float32
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    assert st["ef"]["w"].dtype == torch.float32
    ref = JO.init_opt_state({"w": jnp.zeros((3, 2), jnp.bfloat16)},
                            compress_grads=True)
    assert set(ref) == set(st)


def test_update_is_in_place():
    """The step keeps every parameter's and moment's storage (no leaf-sized
    copy replaces it)."""
    rng = np.random.default_rng(1)
    tp = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    st = TO.init_opt_state(_Module(tp))
    ptrs = [t.data_ptr() for t in (*tp.values(), *st["mu"].values(),
                                   *st["nu"].values())]
    TO.adamw_update(TCFG, tp, {k: torch.ones_like(v) for k, v in tp.items()},
                    st)
    assert ptrs == [t.data_ptr() for t in (*tp.values(), *st["mu"].values(),
                                           *st["nu"].values())]


def test_chunked_update_equals_whole(monkeypatch):
    """The update cut into chunks gives the same bits as in one piece."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    out = []
    for chunk in (1 << 26, 37):
        monkeypatch.setattr(TO, "CHUNK", chunk)
        pc, mu, nu = p.clone(), torch.zeros(1000), torch.zeros(1000)
        scalars = [torch.tensor(x, dtype=torch.float32)
                   for x in (0.5, 1e-3, 0.1, 0.05)]
        TO._update_leaf(TCFG, pc, g, mu, nu, *scalars)
        out.append((pc, mu, nu))
    for a, b in zip(*out):
        assert torch.equal(a, b)
