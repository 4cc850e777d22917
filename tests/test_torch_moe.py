"""The port's mixture-of-experts block against ``repro.models.transformer``.

``moe_dispatch`` (routing, positions, capacity and the expert token
buffer) must equal the reference's dispatch exactly on the same float32
probabilities, including where two experts tie and where a dropped
assignment overwrites a kept token's slot (fault (t): the reference's
scatter on duplicate indices, the largest flat index t·K + k winning on
the CPU).  ``moe_block``, ``loss_fn`` and its gradients are held in
float32 by the training tests' ``within_spread``: 8 × the reference's own
float32-vs-float64 spread, plus one float32 ulp of the largest entry; the
tokens that the reference zeroes must be zero bit for bit.  Every
case that can overflow is asserted to overflow.

The reference's ``moe_block`` cannot run under ``jax.enable_x64`` as it
stands: its scan carries int32 counts, and ``oh.sum(0)`` turns them into
int64.  Its float64 runs here see a ``jnp`` whose ``int32`` is int64 (the
index arrays widened; no float changes).
"""

import contextlib
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
from repro.configs import lm_family as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import lm_family as TF  # noqa: E402
from repro_torch.convert import transformer_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_train_lm import within_spread  # noqa: E402
from test_torch_transformer import dispatches  # noqa: E402,F401  (fixture)


class _Jnp:
    """``jnp`` as the reference module sees it: with ``wide_ints`` its
    ``int32`` is int64 (the float64 runs), and every ``einsum``'s spec
    and operands are appended to ``calls``."""

    def __init__(self, wide_ints=False):
        self.wide_ints = wide_ints
        self.calls = []

    def __getattr__(self, name):
        if name == "int32" and self.wide_ints:
            return jnp.int64
        return getattr(jnp, name)

    def einsum(self, spec, *ops):
        self.calls.append((spec, ops))
        return jnp.einsum(spec, *ops)


@contextlib.contextmanager
def reference_x64():
    """The reference in float64 (see the module's docstring)."""
    with jax.enable_x64(True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JT, "jnp", _Jnp(wide_ints=True))
            yield


def _cfgs(e, k, d=32, f=16, n_shared=0, norm=True):
    """The same one-layer MoE config from each package (float32)."""
    base = dict(name="moe-test", n_layers=1, d_model=d, n_heads=1,
                n_kv_heads=1, d_ff=f, vocab=8, dtype="float32")
    tcfg = TT.TransformerConfig(moe=TT.MoEConfig(
        n_experts=e, top_k=k, d_expert_ff=f, n_shared=n_shared,
        d_shared_ff=3 * f if n_shared else 0, router_norm_topk=norm), **base)
    return _jax_cfg(tcfg), tcfg


def _jax_cfg(tcfg):
    """The reference's config with the fields of the port's ``tcfg``."""
    fields = dataclasses.asdict(tcfg)
    moe = fields.pop("moe")
    return JT.TransformerConfig(moe=JT.MoEConfig(**moe), **fields)


def _reference_dispatch(probs, m):
    """The reference's dispatch, lines 159-185 of
    ``src/repro/models/transformer.py`` as they stand (``moe_block`` keeps
    them inline), on given probabilities."""
    T, E, K = probs.shape[0], m.n_experts, m.top_k
    C = max(int(np.ceil(T * K / E * m.capacity_factor)), 1)
    top_p, top_e = jax.lax.top_k(probs, K)
    if m.router_norm_topk:
        top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)

    def slot(counts, e_col):
        oh = jax.nn.one_hot(e_col, E, dtype=jnp.int32)
        pos_in = jnp.cumsum(oh, axis=0) - 1
        pos = jnp.take_along_axis(pos_in, e_col[:, None], 1)[:, 0] \
            + counts[e_col]
        return counts + oh.sum(0), pos

    _, pos_k = jax.lax.scan(slot, jnp.zeros((E,), jnp.int32), top_e.T)
    pos = pos_k.T
    keep = pos < C
    pos_c = jnp.where(keep, pos, C - 1)
    tok_ids = jnp.broadcast_to(jnp.arange(T)[:, None], (T, K))
    idx_buf = jnp.full((E, C), T, jnp.int32)
    idx_buf = idx_buf.at[top_e, pos_c].set(jnp.where(keep, tok_ids, T),
                                           mode="drop")
    return top_p, top_e, pos, keep, idx_buf


def _random_probs(t, e, seed, ties=False):
    """Softmax rows of skewed logits (later experts favoured, so capacity
    binds); with ``ties`` every row repeats its largest logit at another
    expert."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)) * 2 + np.linspace(0, 3, e)
    if ties:
        top = logits.argmax(1)
        other = (top + 1 + rng.integers(0, e - 1, size=t)) % e
        logits[np.arange(t), other] = logits[np.arange(t), top]
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


def _same(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def _overflows(dispatch):
    keep = dispatch[3]
    return not bool(np.asarray(keep).all())


# the two configs' expert counts and top-K at smoke and full width
ROUTERS = [(8, 4), (60, 4), (128, 8)]


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("t", [1, 8, 64, 257, 48])
@pytest.mark.parametrize("e,k", ROUTERS)
def test_moe_dispatch_equals_reference_exactly(e, k, t, norm):
    """All five outputs equal the reference's: top_p bit for bit, the rest
    as integers.  T = 48 at E = 60, K = 4 makes T·K/E·1.25 an integer
    (C = 4); every T > 1 overflows."""
    _, tcfg = _cfgs(e, k, norm=norm)
    probs = _random_probs(t, e, seed=t + e)
    want = _reference_dispatch(jnp.asarray(probs), tcfg.moe)
    got = TT.moe_dispatch(torch.from_numpy(probs.copy()), tcfg.moe)
    for g, w in zip(got, want):
        _same(g.numpy(), w)
    assert TT.capacity(t, tcfg.moe) == np.asarray(want[4]).shape[1]
    assert _overflows(want) == (t > 1)


@pytest.mark.parametrize("e,k", ROUTERS)
def test_moe_dispatch_ties_go_to_the_lower_expert(e, k):
    """Where two experts tie on probability (in every row here), the lower
    index ranks first, as ``lax.top_k`` orders them."""
    _, tcfg = _cfgs(e, k)
    probs = _random_probs(64, e, seed=5, ties=True)
    want = _reference_dispatch(jnp.asarray(probs), tcfg.moe)
    got = TT.moe_dispatch(torch.from_numpy(probs.copy()), tcfg.moe)
    for g, w in zip(got, want):
        _same(g.numpy(), w)
    tied = probs[:, None, :] == probs[:, :, None]
    assert (tied.sum((1, 2)) > probs.shape[1]).all()
    assert _overflows(want)


@pytest.mark.parametrize("e,k", ROUTERS)
def test_moe_dispatch_keeps_a_given_routing(e, k):
    """Given ``top_e`` (a replay that keeps another run's routing), the
    dispatch is the one those experts give: its own top-K passed back
    changes nothing, and another routing moves top_p to its experts'
    probabilities."""
    _, tcfg = _cfgs(e, k)
    probs = torch.from_numpy(_random_probs(64, e, seed=3).copy())
    own = TT.moe_dispatch(probs, tcfg.moe)
    for g, w in zip(TT.moe_dispatch(probs, tcfg.moe, top_e=own[1]), own):
        assert torch.equal(g, w)
    other = own[1].flip(1)                  # the same experts, slots reversed
    got = TT.moe_dispatch(probs, tcfg.moe, top_e=other)
    assert torch.equal(got[1], other)
    np.testing.assert_allclose(got[0].numpy(), own[0].flip(1).numpy(),
                               rtol=1e-6)
    assert not torch.equal(got[2], own[2].flip(1))   # slot-major positions


def test_moe_dispatch_model_is_the_reference_s():
    """``chip_smoke.dispatch_model``, the plain model that phase 12a holds
    the card's dispatch against, equals the reference's dispatch."""
    for e, k in ROUTERS:
        _, tcfg = _cfgs(e, k)
        probs = _random_probs(257, e, seed=e, ties=True)
        want = _reference_dispatch(jnp.asarray(probs), tcfg.moe)
        for g, w in zip(chip_smoke.dispatch_model(probs, tcfg.moe), want):
            _same(g, w)


def _reference_buffer(monkeypatch, x, lp, jcfg):
    """(probs, idx_buf) of the reference's own ``moe_block`` on ``x``: the
    router's logits and the gathered expert buffer xe are the first two
    einsums' outputs and operands; each row of xe is a row of x (found by
    equality) or the zero sentinel row (T)."""
    rec = _Jnp()
    monkeypatch.setattr(JT, "jnp", rec)
    out = JT.moe_block(jnp.asarray(x), {n: jnp.asarray(w)
                                        for n, w in lp.items()}, jcfg)
    monkeypatch.undo()
    (spec0, _), (spec1, (xe, _)) = rec.calls[:2]
    assert (spec0, spec1) == ("td,de->te", "ecd,edf->ecf")
    logits = jnp.einsum("td,de->te", jnp.asarray(x),
                        jnp.asarray(lp["router"]))
    xe = np.asarray(xe)
    match = (xe[:, :, None, :] == x[None, None]).all(-1)      # [E, C, T]
    idx = np.where(match.any(-1), match.argmax(-1), x.shape[0])
    assert (match.sum(-1) <= 1).all()
    assert (xe[idx == x.shape[0]] == 0).all()
    return np.asarray(jax.nn.softmax(logits, -1)), idx, np.asarray(out)


# chip_smoke.py's probes of the reference's scatter (phase 12a): token t
# one-hot at t (D = T), its router row 4.0 at its first expert and 2.0 at
# its second; E = 4 at K = 2 (C = 3) and E = 2 at K = 1 (C = 3)
PROBES = [c for c in chip_smoke.MOE_SMALL_CASES if c[0].startswith("probe")]


@pytest.mark.parametrize("case", PROBES, ids=[c[0] for c in PROBES])
def test_fault_t_probes(monkeypatch, case):
    """The reference's three probes: its own expert buffer equals
    ``moe_dispatch``'s, and the outputs agree, the tokens it zeroes
    (kept, but their slot overwritten by a later dropped assignment) zero
    bit for bit."""
    name, zeroed = case[0], case[7]
    tcfg, x, lp = chip_smoke.moe_case(case, "float32")
    jcfg = _jax_cfg(tcfg)
    x, lp = x.numpy(), {n: w.numpy() for n, w in lp.items()}
    probs, idx, want = _reference_buffer(monkeypatch, x, lp, jcfg)
    disp = TT.moe_dispatch(torch.from_numpy(probs.copy()), tcfg.moe)
    np.testing.assert_array_equal(disp[4].numpy(), idx)
    got = TT.moe_block(torch.from_numpy(x),
                       {n: torch.from_numpy(w) for n, w in lp.items()},
                       tcfg).numpy()
    zero = [t for t in range(4) if not want[t].any()]
    assert zero == zeroed
    assert [t for t in range(4) if not got[t].any()] == zeroed
    with reference_x64():
        want64 = np.asarray(JT.moe_block(
            jnp.asarray(x, jnp.float64),
            {n: jnp.asarray(w, jnp.float64) for n, w in lp.items()}, jcfg))
    within_spread(got, want, want64, name)
    # the port undone (a kept token always keeps its slot) is not the
    # reference wherever a probe overwrites
    top_p, top_e, pos, keep, buf = disp
    fixed = buf.clone()
    fixed[top_e[keep], pos[keep]] = torch.arange(4)[:, None].expand(
        -1, top_e.shape[1])[keep]
    assert torch.equal(fixed, buf) == (name == "probe_kept_survives")


def _random_block(t, n_shared, norm, seed):
    """A random MoE layer whose router favours later experts (x carries a
    constant last column; the router's last row rises over the experts),
    so capacity binds."""
    e, k, d, f = 8, 4, 32, 16
    jcfg, tcfg = _cfgs(e, k, d, f, n_shared, norm)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[:, -1] = 1.0
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    router[-1] = np.linspace(0.0, 3.0, e)
    lp = {"router": router}
    shapes = {"e_gate": (e, d, f), "e_up": (e, d, f), "e_down": (e, f, d)}
    if n_shared:
        fs = 3 * f
        shapes.update(s_gate=(d, fs), s_up=(d, fs), s_down=(fs, d),
                      s_gate_proj=(d, 1))
    for n, shape in shapes.items():
        lp[n] = (rng.standard_normal(shape) / np.sqrt(shape[-2])
                 ).astype(np.float32)
    return jcfg, tcfg, x, lp


def _both_blocks(jcfg, tcfg, x, lp):
    want = np.asarray(JT.moe_block(jnp.asarray(x), {
        n: jnp.asarray(w) for n, w in lp.items()}, jcfg))
    with reference_x64():
        want64 = np.asarray(JT.moe_block(jnp.asarray(x, jnp.float64), {
            n: jnp.asarray(w, jnp.float64) for n, w in lp.items()}, jcfg))
    got = TT.moe_block(torch.from_numpy(x), {
        n: torch.from_numpy(w) for n, w in lp.items()}, tcfg).numpy()
    return got, want, want64


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("n_shared", [0, 4], ids=["routed", "shared"])
@pytest.mark.parametrize("t", [1, 8, 64, 257])
def test_moe_block_matches_reference(monkeypatch, t, n_shared, norm):
    jcfg, tcfg, x, lp = _random_block(t, n_shared, norm, seed=t)
    got, want, want64 = _both_blocks(jcfg, tcfg, x, lp)
    assert got.shape == (t, x.shape[1]) and got.dtype == np.float32
    within_spread(got, want, want64, "moe_block")
    probs, idx, _ = _reference_buffer(monkeypatch, x, lp, jcfg)
    disp = TT.moe_dispatch(torch.from_numpy(probs.copy()), tcfg.moe)
    np.testing.assert_array_equal(disp[4].numpy(), idx)
    assert _overflows(disp) == (t > 1)       # one token never overflows


def test_moe_block_spreads_a_non_finite_expert_output():
    """An inf in one expert's down projection makes its empty slots NaN
    (0 · inf); every token that gathers such a slot, dropped or not,
    turns NaN through its zero weight, as in the reference: the NaN
    pattern is the reference's, and the finite entries agree."""
    jcfg, tcfg, x, lp = _random_block(64, 0, True, seed=9)
    lp["e_down"][7, 3, 5] = np.inf
    got, want, want64 = _both_blocks(jcfg, tcfg, x, lp)
    nan = np.isnan(want)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    within_spread(got[fin], want[fin], want64[fin], "finite entries")


def _smoke_model(arch, seed):
    jcfg = JF.LM_SPECS[arch].smoke_config
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = transformer_from_jax(jax.tree.map(np.asarray, params),
                                 TF.get_config(arch, smoke=True), "cpu")
    return jcfg, params, model


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_loss_fn_value_and_gradients_match_reference(arch, dispatches):
    """The loss and every leaf's gradient (router, experts and the shared
    expert's gate included) against ``jax.value_and_grad``, within the
    reference's float32-vs-float64 spread, on the smoke batch (T = 128
    a layer, C = 80): capacity binds."""
    from repro_torch.convert import model_tree
    from repro_torch.dist.checkpoint import Stacked, tree_leaves
    jcfg, params, model = _smoke_model(arch, seed=2)
    batch = TF.smoke_batch(model.cfg, "train", seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jv, jg = jax.value_and_grad(JT.loss_fn)(params, jb, jcfg)
    with reference_x64():
        p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
        jv64, jg64 = jax.value_and_grad(JT.loss_fn)(p64, jb, jcfg)
    model.requires_grad_(True)
    loss = TF.loss_fn(model, batch)
    loss.backward()
    within_spread(loss.item(), jv, jv64, "loss")
    grads = model_tree(model, {n: p.grad for n, p in
                               model.named_parameters()})
    got = [torch.stack(list(g)).numpy() if isinstance(g, Stacked)
           else g.numpy() for g in tree_leaves(grads)]
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert len(got) == len(names)
    assert any("router" in n for n in names) and any("e_down" in n
                                                      for n in names)
    for g, a, b, n in zip(got, jax.tree.leaves(jg), jax.tree.leaves(jg64),
                          names):
        within_spread(g, a, b, n)
    assert any(not bool(d[3].all()) for d in dispatches)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_init_params_matches_jax_distribution(arch):
    """Every MoE leaf, the router and the shared expert's gate included,
    is N(0, 1/n_layers) as in the reference (fault (h)): in each package
    the sample standard deviation is 1/√n_layers within 5 standard errors
    (1/√(2n) relative for n draws; s_gate_proj has only 256)."""
    cfg = dataclasses.replace(TF.get_config(arch, smoke=True), n_layers=4)
    jcfg = dataclasses.replace(JF.LM_SPECS[arch].smoke_config, n_layers=4)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(jp["layers"]) == set(TT.layer_shapes(cfg))
    for name, leaf in jp["layers"].items():
        got = torch.stack([getattr(l, name) for l in model.layers]).numpy()
        if leaf.std() == 0:
            np.testing.assert_array_equal(got, leaf, err_msg=name)
            continue
        tol = 5 / np.sqrt(2 * leaf.size)
        for sample in (got, leaf):
            assert abs(sample.std() * np.sqrt(4) - 1) < tol, name


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen2-moe-a2.7b"])
def test_decode_step_with_widened_weights(arch):
    """``decode_step(..., dtype=float32)`` of a bfloat16 model against a
    float32 cache == the decode of the same weights stored in float32."""
    cfg = dataclasses.replace(TF.get_config(arch, smoke=True),
                              dtype="bfloat16")
    model = TT.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    f32 = TT.Transformer(dataclasses.replace(cfg, dtype="float32"))
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    caches = [TT.init_cache(cfg, 3, 8, "cpu", torch.float32),
              TT.init_cache(f32.cfg, 3, 8, "cpu")]
    for step in range(4):
        toks = torch.tensor([1, 7, 300]) + step
        got, _ = TT.decode_step(model, caches[0], toks, torch.float32)
        want, _ = TT.decode_step(f32, caches[1], toks)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    assert torch.equal(caches[0]["k"], caches[1]["k"])


# ------------------------------------------------------------------ #
# chip_smoke.py's MoE phases on the CPU
# ------------------------------------------------------------------ #
def test_chip_smoke_moe_small_on_the_cpu():
    """Phase 12a with the CPU as both devices: every case's checks hold,
    and the cases cover what they name."""
    assert chip_smoke.phase_moe_small(torch.device("cpu")) == 0.0
    caps = {}
    for case in chip_smoke.MOE_SMALL_CASES:
        cfg, _, _ = chip_smoke.moe_case(case, "float32")
        caps[case[0]] = TT.capacity(case[1], cfg.moe)
    assert caps["decode_c1"] == 1 and caps["integer_capacity"] == 4
    m = chip_smoke.moe_case(chip_smoke.MOE_SMALL_CASES[5], "float32")[0].moe
    assert 48 * m.top_k / m.n_experts * m.capacity_factor == 4.0


def test_chip_smoke_moe_small_refuses_kept_always_wins():
    """A dispatch that lets a kept token always keep its slot (fault (t)
    undone, the 'correct' drop) fails phase 12a's exact check."""
    def kept_wins(real, probs, m):
        top_p, top_e, pos, keep, buf = real(probs, m)
        buf = buf.clone()
        tok = torch.arange(top_e.shape[0])[:, None].expand_as(top_e)
        buf[top_e[keep], pos[keep]] = tok[keep]
        return top_p, top_e, pos, keep, buf
    with chip_smoke.patched_dispatch(kept_wins), \
            pytest.raises(AssertionError, match="dispatch_model"):
        chip_smoke.phase_moe_small(torch.device("cpu"))


def test_chip_smoke_moe_serve_on_the_cpu():
    """Phase 12b at a bfloat16 smoke config with 4 slots (C = 3 at
    decode): equal tokens on two calls, no launches on the CPU, capacity
    binds, the logits pass the float32-replay check and the fp8-weight
    replay fails it."""
    cfg = dataclasses.replace(TF.get_config("qwen2-moe-a2.7b", smoke=True),
                              dtype="bfloat16")
    row = chip_smoke.phase_moe_serve(torch.device("cpu"), 3.35e12, cfg=cfg,
                                     slots=4, max_len=64, lens=(8, 24),
                                     max_new=8)
    assert row["tokens_equal"] and row["capacity"] == 3
    assert [c["launches"] for c in row["calls"]] == [0, 0]
    assert row["dropped_share"] > 0 and row["kept_overwritten_share"] > 0
    e = cfg.moe.n_experts
    assert 0 < row["experts_holding"] <= row["experts_chosen"] <= e
    assert (row["routed_bound_ms"] < row["gather_bound_ms"]) == (
        row["experts_holding"] < e)
    assert row["logits_vs_f32"]["mean_abs"] <= row["mean_abs_tol"]
    assert row["fp8_weights_vs_f32"]["mean_abs"] > row["mean_abs_tol"]
    assert row["conditioned"]["arch"] == cfg.name


def test_chip_smoke_served_splits_on_an_h100():
    """The split rule at the serving phases' shapes on an H100's 132 SMs:
    Qwen3-MoE's longest prompt and 16 new tokens take the cache into
    gqa_decode's second split of 256 positions; Qwen2.5-14B's 1,024
    positions are two splits of 512, its served data in the first."""
    from repro_torch.configs.lm_family import get_config
    moe3 = chip_smoke.moe3_config()
    lens = [len(p) for p in chip_smoke.rag_prompts(
        moe3.vocab, chip_smoke.LM_SLOTS, chip_smoke.MOE3_PROMPT_LENS)]
    steps = max(lens) + chip_smoke.MOE_MAX_NEW
    assert chip_smoke.served_splits(
        "cpu", moe3, chip_smoke.LM_SLOTS, chip_smoke.LM_MAX_LEN, steps,
        sms=132) == {"splits": 4, "chunk": 256, "holding_data": 2}
    lm = get_config(chip_smoke.LM_ARCH)
    assert chip_smoke.served_splits(
        "cpu", lm, chip_smoke.LM_SLOTS, chip_smoke.LM_MAX_LEN,
        chip_smoke.LM_PROMPT_LENS[1] + chip_smoke.LM_MAX_NEW,
        sms=132) == {"splits": 2, "chunk": 512, "holding_data": 1}
    assert chip_smoke.served_splits("cpu", lm, 8, 1024, 94) is None


def test_chip_smoke_moe_serve_qwen3_on_the_cpu():
    """Phase 12c (``moe_serve_qwen3``) at Qwen3-MoE's bfloat16 smoke
    config with 16 query heads on 1 KV head (the full config's G = 16), 4
    slots: equal tokens on two calls, no launches on the CPU, capacity
    binds, the float32-replay check passes and its fp8 replay fails it,
    and the conditioned check runs at one layer of the same config."""
    cfg = dataclasses.replace(
        TF.get_config("qwen3-moe-235b-a22b", smoke=True), dtype="bfloat16",
        n_heads=16, n_kv_heads=1)
    assert cfg.group_size == chip_smoke.moe3_config().group_size == 16
    row = chip_smoke.phase_moe_serve(torch.device("cpu"), 3.35e12, cfg=cfg,
                                     slots=4, max_len=64, lens=(8, 24),
                                     max_new=8, phase="moe_serve_qwen3")
    assert row["tokens_equal"] and row["g"] == 16 and row["capacity"] == 3
    assert [c["launches"] for c in row["calls"]] == [0, 0]
    assert row["dropped_share"] > 0
    assert row["logits_vs_f32"]["mean_abs"] <= row["mean_abs_tol"]
    assert row["fp8_weights_vs_f32"]["mean_abs"] > row["mean_abs_tol"]
    assert row["conditioned"]["arch"] == cfg.name
    assert row["conditioned"]["layers"] == 1


def test_chip_smoke_qwen3_cut_keeps_the_full_width():
    """Phase 12c's model: Qwen3-MoE-235B at full width, 2 of its 94 layers
    (about 6.2 B parameters, 12.4 GB in bfloat16), C = 1 at 8 slots."""
    cfg = chip_smoke.moe3_config()
    full = TF.get_config("qwen3-moe-235b-a22b")
    assert dataclasses.replace(cfg, n_layers=full.n_layers) == full
    assert cfg.n_layers == 2 and cfg.group_size == 16 and cfg.head_dim == 128
    assert 6.0e9 < cfg.param_count() < 6.4e9
    assert TT.capacity(chip_smoke.LM_SLOTS, cfg.moe) == 1
