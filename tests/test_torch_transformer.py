"""The port's transformer against ``repro.models.transformer``.

Weights come from the JAX init (``jax.tree.map(np.asarray, params)``) and
are carried across by ``convert.transformer_from_jax``; inits are compared
only in distribution (the two generators differ).  Logits, the whole KV
cache and ``length`` are compared in float32 at rtol/atol 2e-4, the
tolerance of the reference's own decode == forward test
(``tests/test_arch_smoke.py``): the port's attention sums in another order
(the ``gqa_decode`` plain version on the CPU), so agreement is to rounding.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import lm_family as JF
from repro.models import transformer as JT
from repro_torch.configs import lm_family as TF
from repro_torch.convert import transformer_from_jax
from repro_torch.models import transformer as TT

TOL = dict(rtol=2e-4, atol=2e-4)


def _configs(arch, **over):
    """The same smoke config from each package."""
    j = JF._smoke(JF.LM_SPECS[arch].config, **over)
    t = TF._smoke(TF.CONFIGS[arch], **over)
    return j, t


# internlm2 (G = 2), qwen2.5 (QKV bias), and a dense config with QK-norm
CASES = {
    "internlm2-1.8b": ("internlm2-1.8b", {}),
    "qwen2.5-14b": ("qwen2.5-14b", {}),
    "dense-qk-norm": ("qwen2.5-14b", {"name": "dense-qk-norm-smoke",
                                      "qk_norm": True}),
}


def _model(case, seed=0, **over):
    arch, base = CASES[case]
    jcfg, tcfg = _configs(arch, **{**base, **over})
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = transformer_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")
    return jcfg, params, model


def _np(x):
    return x.detach().cpu().float().numpy().copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["qwen2.5-14b", "dense-qk-norm"])
def test_convert_round_trips_every_leaf(case, dtype):
    """Every leaf arrives bit for bit, bfloat16 included (reinterpreted
    through int16, since ``torch.from_numpy`` refuses ml_dtypes arrays)."""
    jcfg, params, model = _model(case, seed=1, dtype=dtype)
    np_params = jax.tree.map(np.asarray, params)
    view = np.int16 if dtype == "bfloat16" else np.int32
    tview = torch.int16 if dtype == "bfloat16" else torch.int32

    def same(t, a, what):
        assert t.dtype == model.cfg.torch_dtype, what
        np.testing.assert_array_equal(t.contiguous().view(tview).numpy(),
                                      np.ascontiguousarray(a).view(view),
                                      err_msg=what)

    assert set(np_params["layers"]) == set(TT.layer_shapes(model.cfg))
    for name, leaf in np_params["layers"].items():
        stacked = torch.stack([getattr(l, name) for l in model.layers])
        same(stacked, leaf, f"layers.{name}")
    for name in ("embed", "final_norm", "lm_head"):
        same(getattr(model, name), np_params[name], name)


def test_convert_refuses_mismatched_params():
    jcfg, params, _ = _model("qwen2.5-14b")
    np_params = jax.tree.map(np.asarray, params)
    tcfg = TF.get_config("internlm2-1.8b", smoke=True)       # no QKV bias
    with pytest.raises(ValueError, match="do not match"):
        transformer_from_jax(np_params, tcfg)
    wide = dataclasses.replace(TF.get_config("qwen2.5-14b", smoke=True),
                               d_ff=256)
    with pytest.raises(ValueError, match="shape"):
        transformer_from_jax(np_params, wide)
    bf16 = dataclasses.replace(TF.get_config("qwen2.5-14b", smoke=True),
                               dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        transformer_from_jax(np_params, bf16)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    jcfg, params, model = _model(case, seed=2)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, size=(2, 9))
    want = JT.forward(params, jnp.asarray(toks, jnp.int32), jcfg)
    got = TT.forward(model, torch.from_numpy(toks))
    assert got.shape == (2, 9, jcfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(TT.prefill(model, torch.from_numpy(toks))),
                               np.asarray(want), **TOL)


def _decode_both(case, steps, seq_len, seed=4, start=(0, 0, 0), **over):
    """Decode ``steps`` tokens through both packages from cache lengths
    ``start``, comparing logits, the whole cache and ``length`` after every
    step."""
    jcfg, params, model = _model(case, seed=seed, **over)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, size=(steps, 3)).astype(np.int32)
    jcache = JT.init_cache(jcfg, 3, seq_len)
    jcache["length"] = jnp.asarray(start, jnp.int32)
    tcache = TT.init_cache(model.cfg, 3, seq_len, device="cpu")
    tcache["length"][:] = torch.tensor(start, dtype=torch.int32)
    step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jcfg))
    for i in range(steps):
        jlog, jcache = step(params, jcache, jnp.asarray(toks[i]))
        tlog, out = TT.decode_step(model, tcache, torch.from_numpy(toks[i]))
        assert out is tcache                  # updated in place
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL,
                                   err_msg=f"logits, step {i}")
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[key]),
                                       np.asarray(jcache[key]), **TOL,
                                       err_msg=f"cache {key}, step {i}")
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
    return tcache


@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_jax(case):
    cache = _decode_both(case, steps=6, seq_len=8)
    assert cache["length"].tolist() == [6, 6, 6]


@pytest.mark.parametrize("max_seq_len", [256, 4])
@pytest.mark.parametrize("start", [(0, 0, 0), (3, 0, 1)])
def test_decode_past_the_cache_end_drops_writes(max_seq_len, start):
    """S = 4, 6 steps: writes at length ≥ S are dropped row by row and
    length still grows; with max_seq_len = 4 the RoPE positions clamp as
    well."""
    cache = _decode_both("qwen2.5-14b", steps=6, seq_len=4, start=start,
                         max_seq_len=max_seq_len)
    assert cache["length"].tolist() == [n + 6 for n in start]


def test_decode_matches_forward():
    """The port's incremental decode == its own full forward (causal
    consistency), as the reference's test of itself."""
    _, _, model = _model("internlm2-1.8b", seed=3)
    toks = np.array([[5, 9, 2, 7, 4, 1]], dtype=np.int64)
    full = TT.forward(model, torch.from_numpy(toks))
    cache = TT.init_cache(model.cfg, 1, 8, device="cpu")
    dec = [TT.decode_step(model, cache, torch.from_numpy(toks[:, i]))[0]
           for i in range(toks.shape[1])]
    np.testing.assert_allclose(_np(full), _np(torch.stack(dec, 1)), **TOL)


def test_forward_with_widened_weights():
    """``forward(..., dtype=float32)`` of a bfloat16 model == the forward of
    the same weights stored in float32."""
    _, _, model = _model("qwen2.5-14b", seed=5, dtype="bfloat16")
    f32 = TT.Transformer(dataclasses.replace(model.cfg, dtype="float32"))
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 512, (2, 5)))
    got = TT.forward(model, toks, dtype=torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, TT.forward(f32, toks))


# fields that steer the JAX package's compiler and sharding only
JAX_ONLY = {"scan_unroll", "moe_shard"}


def test_configs_equal_jax_field_by_field():
    assert TF.SHAPES == JF.SHAPES
    assert set(TF.CONFIGS) == set(JF.LM_SPECS)
    for name, spec in JF.LM_SPECS.items():
        for j, t in ((spec.config, TF.get_config(name)),
                     (spec.smoke_config, TF.get_config(name, smoke=True))):
            jd = dataclasses.asdict(j)
            assert dataclasses.asdict(t) == {
                f.name: jd[f.name] for f in dataclasses.fields(t)}, name
            assert set(jd) - set(dataclasses.asdict(t)) == JAX_ONLY, name
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
            assert t.group_size == j.group_size
            assert t.torch_dtype == {"bfloat16": torch.bfloat16,
                                     "float32": torch.float32}[t.dtype]
    with pytest.raises(KeyError):
        TF.get_config("gpt-2")


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "qwen2-moe-a2.7b"])
def test_moe_config_raises(name):
    cfg = TF.get_config(name, smoke=True)
    with pytest.raises(NotImplementedError, match="moe_block"):
        TT.Transformer(cfg)
    with pytest.raises(NotImplementedError, match="moe_block"):
        TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_chunked_attention_raises():
    """attn_chunk_q (blocked attention) runs the chunked path where the
    prompt is longer than the chunk, equal to the plain path within the
    reference's own 2e-4 (``tests/test_perf_paths.py``); a length that is
    not a multiple of the chunk raises, as the reference's reshape does."""
    cfg = dataclasses.replace(TF.get_config("qwen2.5-14b", smoke=True),
                              attn_chunk_q=4)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plain = TT.Transformer(dataclasses.replace(cfg, attn_chunk_q=0), "cpu")
    plain.load_state_dict(model.state_dict())
    toks = torch.randint(0, cfg.vocab, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(TT.forward(model, toks).numpy(),
                               TT.forward(plain, toks).numpy(),
                               rtol=2e-4, atol=2e-4)
    TT.forward(model, torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="multiple"):
        TT.forward(model, torch.zeros((1, 5), dtype=torch.int64))


def test_init_params_matches_jax_distribution():
    """Leaf by leaf, the port's init has the JAX init's spread: the same
    standard deviation within 5 % (thousands of draws a leaf), norms 1 and
    biases 0 exactly."""
    cfg = dataclasses.replace(TF.get_config("qwen2.5-14b", smoke=True),
                              n_layers=4)
    jcfg = dataclasses.replace(JF.LM_SPECS["qwen2.5-14b"].smoke_config,
                               n_layers=4)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, leaf in jp["layers"].items():
        got = torch.stack([getattr(l, name) for l in model.layers]).numpy()
        if leaf.std() == 0:
            np.testing.assert_array_equal(got, leaf, err_msg=name)
        else:
            assert abs(got.std() / leaf.std() - 1) < 0.05, name
    for name in ("embed", "lm_head"):
        got = getattr(model, name).numpy()
        assert abs(got.std() / jp[name].std() - 1) < 0.05, name
    np.testing.assert_array_equal(model.final_norm.numpy(), jp["final_norm"])
    other = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(other.layers[3].w_down, model.layers[3].w_down)
