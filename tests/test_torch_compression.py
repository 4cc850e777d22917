"""The port's gradient compression (``repro_torch.dist.compression``)
against ``repro.dist.compression``: int8 codes, scales and residuals bit
for bit (``jnp.round`` and ``torch.round`` both round half to even).

At a subnormal scale the two differ by design: XLA on the CPU flushes
subnormal inputs and results to zero, PyTorch keeps IEEE arithmetic
(ROADMAP §3, fault (l)).  The test shows both sides of that: the port
with the CPU's flush-to-zero turned on (``torch.set_flush_denormal``)
gives the reference's bits, and without it keeps the subnormal scale.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import compression as JC  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402

SUBNORMAL = [0.0, 0.0, 0.0, 1.1754943508222875e-38]   # fault (l)'s example


def _same(t: "torch.Tensor", j) -> bool:
    a = np.asarray(j)
    return t.numpy().dtype == a.dtype and t.numpy().tobytes() == a.tobytes()


def _trees(rng, scale):
    shapes = {"w": (16, 8), "b": (8,), "t": (3, 5, 7)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _port(grads, res):
    return TC.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in res.items()})


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_compress_bit_for_bit_with_feedback_carry(scale):
    """Five rounds of error feedback: q, scale and residual equal the
    reference's bit for bit each round, and so does the decompression."""
    rng = np.random.default_rng(int(scale * 7) % 1000)
    res = {k: np.zeros_like(v) for k, v in _trees(rng, scale).items()}
    tres = {k: torch.from_numpy(v) for k, v in res.items()}
    jres = {k: jnp.asarray(v) for k, v in res.items()}
    for _ in range(5):
        g = _trees(rng, scale)
        jq, js, jres = JC.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        tq, ts, tres = TC.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres)
        for k in g:
            assert tq[k].dtype == torch.int8
            assert _same(tq[k], jq[k]) and _same(ts[k], js[k])
            assert _same(tres[k], jres[k])
        jd = JC.decompress(jq, js)
        td = TC.decompress(tq, ts)
        assert all(_same(td[k], jd[k]) for k in g)


def test_half_to_even_ties():
    """Values that land exactly on .5 after the division round to even on
    both sides."""
    g = {"x": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5],
                       np.float32)}
    r = {"x": np.zeros(7, np.float32)}
    jq, js, jr = JC.compress_with_feedback(
        {"x": jnp.asarray(g["x"])}, {"x": jnp.asarray(r["x"])})
    tq, ts, tr = _port(g, r)
    assert _same(tq["x"], jq["x"]) and _same(tr["x"], jr["x"])
    assert tq["x"].tolist()[1:6] == [0, 2, 2, 0, -2]


def test_subnormal_scale_flush_to_zero_is_the_only_difference():
    g = {"x": np.array(SUBNORMAL, np.float32)}
    r = {"x": np.zeros(4, np.float32)}
    jq, js, jr = JC.compress_with_feedback(
        {"x": jnp.asarray(g["x"])}, {"x": jnp.asarray(r["x"])})
    # the reference: its subnormal scale is flushed to 0
    assert float(js["x"]) == 0.0
    tq, ts, tr = _port(g, r)
    # the port: IEEE, the scale FLT_MIN / 127 is kept, the residual carries
    # x - q·scale
    assert _same(tq["x"], jq["x"])
    assert ts["x"].item() == pytest.approx(np.finfo(np.float32).tiny / 127)
    assert tr["x"][3].item() != float(np.asarray(jr["x"])[3])
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    try:
        fq, fs, fr = _port(g, r)
    finally:
        torch.set_flush_denormal(False)
    assert _same(fq["x"], jq["x"]) and _same(fs["x"], js["x"])
    assert _same(fr["x"], jr["x"])


def test_init_residual_and_ratio():
    tree = {"a": np.zeros((4, 5), np.float32), "b": np.zeros(3, np.float32)}
    jr = JC.init_residual({k: jnp.asarray(v) for k, v in tree.items()})
    tr = TC.init_residual({k: torch.from_numpy(v) for k, v in tree.items()})
    assert all(_same(tr[k], jr[k]) for k in tree)
    assert TC.compression_ratio({k: torch.from_numpy(v)
                                 for k, v in tree.items()}) == \
        JC.compression_ratio({k: jnp.asarray(v) for k, v in tree.items()})


def test_compressed_train_step_matches_uncompressed_direction():
    """``make_train_step(compress_grads=True)`` carries the residual in the
    optimizer state and moves the parameters as the decompressed gradient
    says (one step, float32, a linear loss)."""
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             make_train_step)
    model = torch.nn.Linear(4, 1, bias=False)
    w0 = model.weight.detach().clone()
    state = init_opt_state(model, compress_grads=True)
    step = make_train_step(lambda m, b: m(b).sum(),
                           AdamWConfig(warmup_steps=0, weight_decay=0.0),
                           compress_grads=True)
    x = torch.tensor([[1.0, -2.0, 0.5, 3.0]])
    state, metrics = step(model, state, x)
    assert set(state) == {"mu", "nu", "step", "ef"}
    moved = torch.sign(w0 - model.weight.detach())
    assert torch.equal(moved, torch.sign(x))
    assert float(metrics["loss"]) == pytest.approx(float((w0 * x).sum()))
