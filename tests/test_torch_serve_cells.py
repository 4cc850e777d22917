"""The registry's serve cells that one card holds (``chip_smoke.py``'s
``SERVE_CELLS`` at their ``ONE_CARD_CUTS``): phase ``dryrun`` over them
on the CPU at bfloat16 smoke configs (the estimate, the FLOPs, the
operators' calls a call, every check of the phase), the port's blocked
prefill against the reference's, DLRM's and xDeepFM's ``serve`` at a
bulk-shaped batch against the reference's ``serve_fn``, and the cut
table's fit rule on CPU fakes at full width."""

import collections
import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402  (the repository root's card script)
from repro.configs import lm_family as JF  # noqa: E402
from repro.configs import recsys_family as JRF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import lm_family as TF  # noqa: E402
from repro_torch.convert import recsys_from_jax  # noqa: E402
from repro_torch.convert import transformer_from_jax  # noqa: E402
from repro_torch.kernels.embedding_bag import kernel as bag_kernel  # noqa
from repro_torch.kernels.gqa_decode import kernel as gqa_kernel  # noqa
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

CPU = torch.device("cpu")
RATIO = C.RECSYS_RATIO


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# phase dryrun over the serve cells on the CPU
# --------------------------------------------------------------------- #
class OpCalls(TorchDispatchMode):
    """Calls of each of the port's kernel operators.  On the card each
    call is one launch that its wrapper counts; on the host the wrappers
    take the plain version and count none, so the phase's launch check
    reads these in their place (:func:`counted_run_cell`)."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.calls[func.name()] += 1
        return func(*args, **(kwargs or {}))


def counted_run_cell(monkeypatch):
    """``run_cell`` whose real steps count the operators' calls into the
    wrappers' launch counts; the phase's checks between the calls (the
    host's recsys run, whose calls are on CPU tensors on the card too)
    are not counted."""
    real_run = dryrun.run_cell

    def run(*args, **kwargs):
        if kwargs.get("seed") is None:
            return real_run(*args, **kwargs)
        ops = OpCalls()
        inspect = kwargs.get("inspect")

        def quiet(a, out):
            ops.paused = True
            try:
                return inspect(a, out)
            finally:
                ops.paused = False
        if inspect:
            kwargs["inspect"] = quiet
        with ops:
            rec = real_run(*args, **kwargs)
        gqa_kernel.launches = ops.calls["repro_torch::gqa_decode"]
        bag_kernel.launches = ops.calls["repro_torch::embedding_bag"]
        return rec
    monkeypatch.setattr(dryrun, "run_cell", run)


def _smoke_cells():
    """(cells, configs, cuts): SERVE_CELLS at bfloat16 smoke configs (the
    phase's logit check needs a bfloat16 forward beside the float32 one),
    each decode cell's gqa_decode calls a layer of the smoke depth, the
    recsys cells' as on the card; batches of 2 sequences, 1 prompt of 64
    tokens in chunks of 16 and 64 rows (the test patches the shapes'
    prefill and long_500k sequences to SMOKE_SEQ)."""
    cells, configs, cuts = {}, {}, {}
    for (arch, shape), want in C.SERVE_CELLS.items():
        spec = get_arch(arch)
        cfg = spec.smoke_config
        kind = C.cell_kind(arch, shape)
        if spec.family == "lm":
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
        full = C.ONE_CARD_CUTS[(arch, shape)]
        if kind == "decode":
            depth = min(full.layers or cfg.n_layers, cfg.n_layers)
            want = {"gqa_decode": depth}
            cut = dataclasses.replace(full, batch=2)
        elif kind == "prefill":
            cut = dataclasses.replace(full, chunk=16)
        else:
            cut = dataclasses.replace(full, batch=64)
        cells[(arch, shape)], configs[arch], cuts[(arch, shape)] = \
            want, cfg, cut
    return cells, configs, cuts


SMOKE_SEQ = {"prefill_32k": 64, "long_500k": 4096}


def test_serve_cells_phase_on_the_cpu(monkeypatch):
    """Every serve cell through phase ``dryrun`` on the host: the real
    step's tracked peak and FLOPs equal the fakes', each decode's estimate
    without its cache refused, the operators called as the card launches
    them, every call's output finite, gqa_decode against its plain
    version at each decode cell's shape, the blocked prefill held to the
    unblocked one (an fp8-weight prefill refused), the recsys rows
    against the host."""
    counted_run_cell(monkeypatch)
    for shape, seq in SMOKE_SEQ.items():
        monkeypatch.setitem(TF.SHAPES[shape], "seq", seq)
    monkeypatch.setattr(C, "PREFILL_CHECK", 128)
    # the smoke caches are far under the 256 MiB floor: 5 % alone
    monkeypatch.setattr(C, "DRYRUN_FLOOR", 0)
    cells, configs, cuts = _smoke_cells()
    out = C.phase_dryrun(CPU, cells, configs=configs, cuts=cuts)
    assert set(out) == {f"{a}/{s}" for a, s in C.SERVE_CELLS}
    for (arch, shape), want in cells.items():
        row = out[f"{arch}/{shape}"]
        assert row["estimate_bytes"] == row["measured_bytes"]
        assert row["flops"] == row["real_flops"] > 0
        assert row["launches_per_call"]["gqa_decode"] == \
            want.get("gqa_decode", 0)
        assert row["launches_per_call"]["embedding_bag"] == \
            want.get("embedding_bag", 0)
        assert len(row["call_s"]) == C.DRYRUN_CALLS and row["ms_per_step"] > 0
        assert all(i["finite"] for i in row["inspected"])
        if row["kind"] == "decode":
            assert row["without_cache_refused"]
            assert row["kernel_shape"][:2] == [
                2, TF.SHAPES[shape]["seq"]]
            assert row["kernel_g"] == configs[arch].group_size
        elif row["kind"] == "prefill":
            check = row["prefill_check"]
            assert check["holds"] and check["fp8_refused"]
            assert check["tokens"] == 128 and check["chunk"] == 16
        else:
            host = row["inspected"][0]["host"]
            assert host["ok"] and host["rows"] == 64
    assert out["qwen3-moe-235b-a22b/decode_32k"]["config"]["n_layers"] == 2
    assert {s for _, s in C.SERVE_CELLS} == {
        "decode_32k", "long_500k", "prefill_32k", "serve_bulk",
        "retrieval_cand"}


def test_serve_cells_phase_refuses_a_wrong_launch_count(monkeypatch):
    """A decode cell whose gqa_decode the main path calls once fewer a
    call than the table says fails the phase."""
    counted_run_cell(monkeypatch)
    cells, configs, cuts = _smoke_cells()
    key = ("internlm2-1.8b", "decode_32k")
    with pytest.raises(AssertionError, match="launches"):
        C.phase_dryrun(CPU, {key: {"gqa_decode": 3}}, configs=configs,
                       cuts=cuts)


def test_serve_cells_table():
    """Every serve cell has a cut; each decode cell's gqa_decode launches
    a call are its cut depth; the recsys counts are phase 13's."""
    for (arch, shape), want in C.SERVE_CELLS.items():
        cut = C.ONE_CARD_CUTS[(arch, shape)]
        cfg, _ = C.cut_cell(arch, shape, cut)
        kind = C.cell_kind(arch, shape)
        if kind == "decode":
            assert want == {"gqa_decode": cfg.n_layers}
        elif kind == "prefill":
            assert want == {} and cut.batch == 1 and cut.chunk == 4096
        else:
            per = C.recsys_calls(arch, get_arch(arch).config, 8, 8)[0][2]
            assert want == {"embedding_bag": per}


# --------------------------------------------------------------------- #
# the port's blocked prefill against the reference's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2.5-14b",
                                  "qwen3-moe-235b-a22b"])
def test_blocked_prefill_matches_jax(arch):
    """``prefill`` with attention chunks of 16 at S = 64, the smoke
    config and the reference's weights, against the reference's prefill
    of the same config; the yardstick is the reference's own spread
    between its blocked and unblocked prefill.  The port's blocked
    prefill moves from its unblocked one by at most 8 × that (+ 1 ulp),
    and lies within that of the reference's blocked prefill beyond where
    the two packages' unblocked prefills already differ."""
    over = {"attn_chunk_q": 16, "attn_chunk_kv": 16}
    jcfg = JF._smoke(JF.LM_SPECS[arch].config, **over)
    tcfg = TF._smoke(TF.CONFIGS[arch], **over)
    jplain = dataclasses.replace(jcfg, attn_chunk_q=0, attn_chunk_kv=0)
    params = JT.init_params(jcfg, jax.random.PRNGKey(7))
    model = transformer_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, size=(2, 64))
    jt = jnp.asarray(toks, jnp.int32)
    want = np.asarray(JT.prefill(params, jt, jcfg), np.float64)
    want_plain = np.asarray(JT.prefill(params, jt, jplain), np.float64)
    spread = np.abs(want - want_plain).max()
    assert spread > 0                  # the two orders round apart
    got = TT.prefill(model, torch.from_numpy(toks)).double().numpy()
    model.cfg = dataclasses.replace(tcfg, attn_chunk_q=0, attn_chunk_kv=0)
    got_plain = TT.prefill(model, torch.from_numpy(toks)).double().numpy()
    ulp = float(np.spacing(np.float32(np.abs(want).max())))
    assert np.abs(got - got_plain).max() <= 8 * spread + ulp
    cross = np.abs(got_plain - want_plain).max()
    assert np.abs(got - want).max() <= cross + 8 * spread + ulp


# --------------------------------------------------------------------- #
# DLRM's and xDeepFM's serve at a bulk-shaped batch
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", ["serve_bulk", "retrieval_cand"])
@pytest.mark.parametrize("name", ["dlrm-rm2", "xdeepfm"])
def test_bulk_serve_matches_jax(name, shape):
    """The cell's batch keys (labels too, which serve leaves) at 4,096
    rows drawn as phase dryrun draws a real step's inputs
    (``launch.dryrun.cell_inputs``: ids uniform over each table), the
    smoke config: within RECSYS_RATIO × the reference's distance from the
    port's float64 run, and the port within that of the reference."""
    import copy
    from repro_torch.configs import recsys_family as TRF
    spec = get_arch(name)
    cfg = spec.smoke_config
    _, specs = C.cut_cell(name, shape, C.Cut(batch=4096), cfg)
    gen = torch.Generator().manual_seed(11)
    batch = {k: v.numpy() for k, v in dryrun.cell_inputs(
        spec, cfg, specs, CPU, gen).items()}
    jspec = JRF.RECSYS_SPECS[name]
    params = jspec.init_fn(jspec.smoke_config, jax.random.PRNGKey(5))
    model = recsys_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    want = np.asarray(jspec.serve_fn(params, jspec.smoke_config, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    got = TRF.serve(name, model, batch).numpy()
    got64 = TRF.serve(name, copy.deepcopy(model).double(), batch).numpy()
    assert got.shape == want.shape == (4096,)
    ulp = float(np.spacing(np.float32(np.abs(want).max())))
    e_jax = np.abs(want.astype(np.float64) - got64).max()
    e_port = np.abs(got.astype(np.float64) - got64).max()
    assert e_jax <= RATIO * e_port + ulp, (e_jax, e_port)
    assert np.abs(got.astype(np.float64) - want).max() <= \
        RATIO * e_jax + ulp


# --------------------------------------------------------------------- #
# the cut table's fit rule on CPU fakes at full width
# --------------------------------------------------------------------- #
def is_train(arch: str, shape: str) -> bool:
    spec = get_arch(arch)
    return spec.cells(spec.config)[shape].kind == "train"


# the serve cells' entries; the train cells' (tens of seconds a depth
# here) are in test_torch_onecard_train.py
FIT_ENTRIES = [key for key, cut in C.ONE_CARD_CUTS.items()
               if cut.fit and not is_train(*key)]


@pytest.mark.parametrize("arch,shape", FIT_ENTRIES,
                         ids=[f"{a}/{s}" for a, s in FIT_ENTRIES])
def test_cut_is_the_largest_that_fits(arch, shape):
    """The entry's estimate is at most FIT_LIMIT, and the next larger
    value of the field the fit rule chose is over it (an entry at the
    cell's own batch or full depth has none).  The prefill cuts are set
    for time, not by the rule, and stay out (tracing one takes up to a
    minute here)."""
    rule = C.fit_rule(arch, shape, CPU)
    assert rule["holds"], rule


def test_fakes_subprocess_gives_the_in_process_records():
    """The serve cells' dry runs in :func:`fakes_start`'s subprocess (the
    card script's, beside its phases) are the records ``run_cell`` gives
    in this process at the same cuts."""
    cells = [("dlrm-rm2", "serve_bulk"), ("xdeepfm", "retrieval_cand")]
    got = C.fakes_collect(C.fakes_start(CPU, cells))
    assert set(got) == set(cells)
    for arch, shape in cells:
        cfg, specs = C.cut_cell(arch, shape)
        want = dryrun.run_cell(arch, shape, CPU, cfg, specs=specs)
        assert got[(arch, shape)]["ok"]
        assert got[(arch, shape)]["memory"] == want["memory"]
        assert got[(arch, shape)]["cost"] == want["cost"]
