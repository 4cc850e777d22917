"""The port's recsys serving against ``repro.models.recsys`` and the
reference's ``serve_fn``s (``repro.configs.recsys_family``).

Weights come from the JAX init (``R.*_init(PRNGKey(0))``) and are carried
across by ``convert.recsys_from_jax``; inputs are the copied synth batches.

Tolerance, derived rather than guessed: both packages round the same sums
in float32, in other orders.  The port's float64 run of the same weights
stands for the exact result.  JAX's distance from it, e_jax, must be
within ``RATIO`` × the port's own float32 distance from it (so a wrong
port cannot inflate the tolerance), and the two float32 outputs must lie
within ``RATIO`` × e_jax of each other, plus one float32 ulp of the
output's largest entry.  ``RATIO`` is ``chip_smoke.RECSYS_RATIO`` (8): on
these configs the port's float32 error measured up to 4.6 × JAX's (DLRM).
"""

import copy
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
from repro.configs import recsys_family as JF  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs import recsys_family as TF  # noqa: E402
from repro_torch.convert import recsys_from_jax  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as bag_kernel  # noqa
from repro_torch.models import recsys as TR  # noqa: E402

ARCHS = list(JF.RECSYS_SPECS)
RATIO = chip_smoke.RECSYS_RATIO
# wrapper calls a serve call makes: (arch, with candidates) → launches
LAUNCHES = {("dlrm-rm2", False): 1, ("xdeepfm", False): 2,
            ("two-tower-retrieval", False): 2,
            ("two-tower-retrieval", True): 3,
            ("sasrec", False): 1, ("sasrec", True): 2}


def _np_params(name, seed=0, cfg=None):
    spec = JF.RECSYS_SPECS[name]
    cfg = cfg or spec.smoke_config
    params = spec.init_fn(cfg, jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


def _port(name, np_params, cfg=None):
    return recsys_from_jax(np_params, cfg or TF.get_config(name, smoke=True),
                           device="cpu")


def _jax_serve(name, params, batch, cfg=None):
    spec = JF.RECSYS_SPECS[name]
    return np.asarray(spec.serve_fn(params, cfg or spec.smoke_config,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()}))


def _assert_matches_jax(got32, got64, want):
    got32, got64 = got32.detach().numpy(), got64.detach().numpy()
    assert got32.shape == got64.shape == want.shape
    ulp = float(np.spacing(np.float32(np.abs(want).max())))
    e_jax = np.abs(want.astype(np.float64) - got64).max()
    e_port = np.abs(got32.astype(np.float64) - got64).max()
    assert e_jax <= RATIO * e_port + ulp, (e_jax, e_port)
    err = np.abs(got32.astype(np.float64) - want).max()
    assert err <= RATIO * e_jax + ulp, (err, e_jax)


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("name", ARCHS)
def test_serve_matches_jax(name, kind):
    """The reference's smoke batch of each kind: ``serve`` with candidates
    for two-tower and SASRec (``"serve"``), without (``"train"``)."""
    params, np_params = _np_params(name)
    model = _port(name, np_params)
    batch = TF.smoke_batch(name, kind)
    want = _jax_serve(name, params, batch)
    got = TF.serve(name, model, batch)
    got64 = TF.serve(name, copy.deepcopy(model).double(), batch)
    assert got.dtype == torch.float32 and got64.dtype == torch.float64
    _assert_matches_jax(got, got64, want)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_matches_jax_on_a_larger_batch(name):
    """512 examples (the serve_p99 batch), another init seed; 256
    candidates that cycle over the items."""
    spec = JF.RECSYS_SPECS[name]
    cfg = spec.smoke_config
    params, np_params = _np_params(name, seed=3)
    model = _port(name, np_params)
    batch = {
        "dlrm-rm2": lambda: jsynth.dlrm_batch(5, 512, cfg.n_dense,
                                              cfg.n_sparse,
                                              cfg.vocab_per_table),
        "xdeepfm": lambda: jsynth.xdeepfm_batch(5, 512, cfg.n_sparse,
                                                cfg.vocab_per_table),
        "two-tower-retrieval": lambda: jsynth.twotower_batch(
            5, 512, cfg.n_users, cfg.n_items, JF.HIST_LEN),
        "sasrec": lambda: jsynth.sasrec_batch(5, 512, cfg.seq_len,
                                              cfg.n_items),
    }[name]()
    if name in ("two-tower-retrieval", "sasrec"):
        batch["cand_ids"] = (np.arange(256) % cfg.n_items).astype(np.int32)
    want = _jax_serve(name, params, batch)
    got = TF.serve(name, model, batch)
    got64 = TF.serve(name, copy.deepcopy(model).double(), batch)
    _assert_matches_jax(got, got64, want)


# fields of the JAX configs that only its compiler reads: none
def test_configs_equal_jax_field_by_field():
    assert TF.BATCHES == JF.BATCHES
    assert (TF.N_CAND, TF.HIST_LEN) == (JF.N_CAND, JF.HIST_LEN)
    assert set(TF.ARCHS) == set(JF.RECSYS_SPECS)
    for name, spec in JF.RECSYS_SPECS.items():
        for j, t in ((spec.config, TF.get_config(name)),
                     (spec.smoke_config, TF.get_config(name, smoke=True))):
            assert type(t).__name__ == type(j).__name__
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            assert t.torch_dtype == torch.float32
            bf = dataclasses.replace(t, dtype="bfloat16")
            assert bf.torch_dtype == torch.bfloat16
    with pytest.raises(KeyError, match="unknown recsys config"):
        TF.get_config("dlrm")


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("name", ARCHS)
def test_smoke_batches_equal_jax(name, kind):
    spec = JF.RECSYS_SPECS[name]
    for seed in (0, 11):
        want = spec.smoke_batch(spec.smoke_config, kind, seed)
        got = TF.smoke_batch(name, kind, seed)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fn,args", [
    ("dlrm_batch", (300, 13, 26, 1_000_000)),
    ("xdeepfm_batch", (300, 39, 100_000)),
    ("twotower_batch", (300, 2_000_000, 1_000_000, 8)),
    ("sasrec_batch", (300, 50, 1_000_000)),
])
def test_synth_batches_equal_jax_at_full_width(fn, args):
    for seed in (0, 4):
        want = getattr(jsynth, fn)(seed, *args)
        got = getattr(tsynth, fn)(seed, *args)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ARCHS)
def test_convert_round_trips_every_leaf(name):
    _, np_params = _np_params(name, seed=1)
    model = _port(name, np_params)
    flat = dict(jax.tree_util.tree_flatten_with_path(np_params)[0])
    assert len(flat) == len(list(model.parameters()))
    for path, leaf in flat.items():
        dotted = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)
        p = model.get_parameter(dotted)
        assert p.dtype == torch.float32 and not p.requires_grad
        np.testing.assert_array_equal(p.numpy().view(np.int32),
                                      np.ascontiguousarray(leaf)
                                      .view(np.int32), err_msg=dotted)


def test_convert_refuses_mismatched_params():
    _, np_params = _np_params("dlrm-rm2")
    cfg = TF.get_config("dlrm-rm2", smoke=True)
    missing = {**np_params, "bot": np_params["bot"][:-1]}
    with pytest.raises(ValueError, match="do not match"):
        recsys_from_jax(missing, cfg, device="cpu")
    extra = {**np_params, "linear": np_params["tables"]}
    with pytest.raises(ValueError, match="do not match"):
        recsys_from_jax(extra, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape|needs"):
        recsys_from_jax(np_params, dataclasses.replace(cfg, embed_dim=8,
                                                       bot_mlp=(13, 32, 8)),
                        device="cpu")
    with pytest.raises(ValueError, match="float32"):
        recsys_from_jax(np_params, dataclasses.replace(cfg, dtype="bfloat16"),
                        device="cpu")
    _, xd = _np_params("xdeepfm")
    with pytest.raises(ValueError, match="do not match"):
        recsys_from_jax(xd, cfg, device="cpu")
    _, sas = _np_params("sasrec")
    scfg = TF.get_config("sasrec", smoke=True)
    with pytest.raises(ValueError, match="blocks.wq"):
        recsys_from_jax(sas, dataclasses.replace(scfg, n_blocks=3),
                        device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_init_distribution_matches_jax(name):
    """Same leaves; biases 0 and LayerNorm gains 1 exactly; every other
    leaf N(0, σ²) with the reference's σ (tables 0.01, dense 1/√shape[0]),
    checked on leaves of at least 1,000 entries against σ and against the
    JAX init's sample std."""
    cfg = dataclasses.replace(TF.get_config(name, smoke=True))
    model = TR.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, jp = _np_params(name, seed=0)
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    names = dict(model.named_parameters())
    assert set(names) == set(jflat)
    for n, p in names.items():
        std = TR._init_std(n, p)
        j = jflat[n]
        if std is None:
            assert (p == float(j.flat[0])).all() and (j == j.flat[0]).all(), n
            continue
        assert std > 0
        if p.numel() >= 1000:
            got = float(p.std())
            assert abs(got / std - 1) < 0.1, (n, got, std)
            assert abs(got / float(j.std()) - 1) < 0.1, n
            assert abs(float(p.mean())) < 4 * std / np.sqrt(p.numel()), n


def test_init_scales_by_leaf():
    """The reference's σ at full width, from shapes alone (no init)."""
    cases = {"tables": 0.01, "linear": 0.01, "cin.0": 1 / np.sqrt(200),
             "cin_out": 1 / np.sqrt(600), "mlp.0.w": 1 / np.sqrt(390),
             "mlp.0.b": None}
    cfg = TF.get_config("xdeepfm")
    model = TR.make_model(dataclasses.replace(cfg, vocab_per_table=3),
                          "cpu")
    for n, want in cases.items():
        got = TR._init_std(n, model.get_parameter(n))
        assert (got is None) if want is None else np.isclose(got, want), n
    sas = TR.make_model(TF.get_config("sasrec", smoke=True), "cpu")
    assert np.isclose(TR._init_std("blocks.wq", sas.blocks.wq), 1 / 4)
    assert TR._init_std("blocks.ln1", sas.blocks.ln1) is None
    assert TR._init_std("pos_embed", sas.pos_embed) == 0.01


@pytest.mark.parametrize("name,cands", list(LAUNCHES))
def test_every_lookup_is_one_wrapper_call(monkeypatch, name, cands):
    """The fixed number of kernel-wrapper calls per serve call, and no
    other way to a table row (the plain version alone would miss none)."""
    calls = []
    real = bag_kernel.embedding_bag

    def counting(table, indices, weights):
        calls.append(tuple(indices.shape))
        return real(table, indices, weights)
    monkeypatch.setattr(bag_kernel, "embedding_bag", counting)
    _, np_params = _np_params(name)
    model = _port(name, np_params)
    batch = TF.smoke_batch(name, "serve" if cands else "train")
    TF.serve(name, model, batch)
    assert len(calls) == LAUNCHES[(name, cands)], calls


def test_field_lookup_keeps_bad_ids_in_their_field():
    """Per field, as the reference's vmap of takes: -1 wraps within the
    field, V and -V-1 give NaN rows (never the next field's row 0 or the
    previous field's last row)."""
    rng = np.random.default_rng(0)
    f, v, d = 3, 5, 4
    tables = rng.standard_normal((f, v, d)).astype(np.float32)
    ids = np.array([[0, 4, -1], [5, -6, 2], [-5, 2 ** 31 - 1, -2 ** 31]],
                   np.int32)
    want = np.asarray(JR._field_lookup(jnp.asarray(tables), jnp.asarray(ids)))
    got = TR._field_lookup(torch.from_numpy(tables),
                           torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert np.isnan(got[1, :2]).all() and np.isnan(got[2, 1:]).all()


def test_dlrm_nan_for_an_out_of_range_id_like_jax():
    params, np_params = _np_params("dlrm-rm2")
    model = _port("dlrm-rm2", np_params)
    batch = TF.smoke_batch("dlrm-rm2", "serve")
    batch["sparse"][3, 2] = 1000                  # = vocab_per_table
    batch["sparse"][5, 0] = -1                    # wraps
    want = _jax_serve("dlrm-rm2", params, batch)
    got = TF.serve("dlrm-rm2", model, batch).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]) and np.isfinite(np.delete(got, 3)).all()


def test_sasrec_scores_zero_rows_as_the_reference_does():
    """Fault (i): left-padded histories, the score taken at len − 1, which
    ``sasrec_encode`` zeroed where 2·len − 1 < S: those score rows are all
    zero in both packages."""
    params, np_params = _np_params("sasrec", seed=2)
    model = _port("sasrec", np_params)
    cfg = JF.SASREC_SMOKE
    batch = jsynth.sasrec_batch(1, 64, cfg.seq_len, cfg.n_items)
    batch = {"item_seq": batch["item_seq"],
             "cand_ids": (np.arange(32) % cfg.n_items).astype(np.int32)}
    want = _jax_serve("sasrec", params, batch)
    got = TF.serve("sasrec", model, batch).numpy()
    zero = (got == 0).all(-1)
    np.testing.assert_array_equal(zero, (want == 0).all(-1))
    lens = (batch["item_seq"] != 0).sum(-1)
    np.testing.assert_array_equal(zero, 2 * lens - 1 < cfg.seq_len)
    assert 0 < zero.mean() < 1
    np.testing.assert_allclose(got[~zero], want[~zero], rtol=1e-5, atol=1e-6)


def test_serve_checks_the_model_and_defaults_to_the_card(monkeypatch):
    _, np_params = _np_params("dlrm-rm2")
    model = _port("dlrm-rm2", np_params)
    with pytest.raises(TypeError, match="XDeepFMConfig"):
        TF.serve("xdeepfm", model, TF.smoke_batch("xdeepfm"))
    with pytest.raises(TypeError, match="not a recsys config"):
        TR.make_model(object(), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TF.get_config("dlrm-rm2", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys_from_jax(np_params, cfg)


@pytest.mark.parametrize("name", ARCHS)
def test_host_subset_serves_the_same_numbers(name):
    """``chip_smoke.host_subset`` (the card run's oracle) gives what the
    whole model gives on the batch, bit for bit."""
    _, np_params = _np_params(name, seed=4)
    model = _port(name, np_params)
    cfg = model.cfg
    for cell, batch, _ in chip_smoke.recsys_calls(name, cfg, 64, 300):
        host, sub = chip_smoke.host_subset(name, model, batch)
        assert sum(p.numel() for p in host.parameters()) <= \
            sum(p.numel() for p in model.parameters())
        assert torch.equal(TF.serve(name, host, sub),
                           TF.serve(name, model, batch)), cell


def test_chip_smoke_recsys_phases_on_the_cpu():
    """``chip_smoke.py``'s phases 11 and 12 on the CPU at the smoke
    configs: their checks hold with the plain version (no launches), and
    SASRec's zero score rows are those fault (i) predicts."""
    cpu = torch.device("cpu")
    assert chip_smoke.phase_bag_small(cpu) == 0.0
    out = chip_smoke.phase_recsys_serve(cpu, smoke=True, n_cand=3000,
                                        timed=1)
    assert set(out) == set(chip_smoke.RECSYS_ARCHS)
    for name, row in out.items():
        for cell, c in row["cells"].items():
            assert c["ok"] and c["launches"] == 0, (name, cell)
    sas = out["sasrec"]["cells"]["serve_p99_scored"]
    assert 0 < sas["zero_score_rows"] < 1
    assert sas["zero_rows_are_2len_minus_1_lt_S"]
    assert out["two-tower-retrieval"]["cells"]["retrieval_cand"]["shape"] \
        == [1, 3000]


def test_recsys_tolerance_refuses_a_wrong_row():
    """Phase 12's comparison passes the host's own output and refuses one
    whose single entry moved by 1e-4 of the output's scale."""
    want = torch.linspace(-1, 1, 512)
    want64 = want.double() + 1e-8
    assert chip_smoke.recsys_close(want, want, want64)["ok"]
    bad = want.clone()
    bad[17] += 1e-4
    assert not chip_smoke.recsys_close(bad, want, want64)["ok"]


def test_chip_smoke_bag_deploy_cases_on_the_cpu():
    """Phase 13's inputs at the smoke configs: the kernel's plain version
    equals the library call on each, and the bound counts distinct rows."""
    cases = chip_smoke.bag_deploy_cases(torch.device("cpu"), bulk=256,
                                        smoke=True)
    assert set(cases) == {"uniform", "zipf", "dlrm"}
    from repro_torch.kernels.embedding_bag import embedding_bag
    for case, (table, ids, w, library) in cases.items():
        got = embedding_bag(table, ids, w)
        torch.testing.assert_close(library().reshape(got.shape), got,
                                   rtol=1e-6, atol=1e-7)
        bound, by, nbytes, rows = chip_smoke.bag_bound(
            ids, table.shape[1], 4, 3.35e12, 67e12)
        assert rows == len(np.unique(ids.numpy())) < ids.numel()
        assert by == "bytes"
        assert nbytes == 4 * (rows * table.shape[1] + 2 * ids.numel()
                              + ids.shape[0] * table.shape[1])
    cfg = TF.get_config("dlrm-rm2", smoke=True)
    table, ids, _, _ = cases["dlrm"]
    assert table.shape == (cfg.n_sparse * cfg.vocab_per_table, cfg.embed_dim)
    field = (ids[:, 0].long() // cfg.vocab_per_table).reshape(256, -1)
    assert torch.equal(field, torch.arange(cfg.n_sparse).expand(256, -1))
