"""The registry's train cells that one card holds (``chip_smoke.py``'s
``ONE_CARD_CUTS`` train entries): the cut table's fit rule on CPU fakes
at full width (each traces for tens of seconds a depth here, so they sit
apart from ``test_torch_serve_cells.py``'s), and phase ``train_families``
(b) over the dense LMs on the CPU at their smoke configs, its estimate
taken in the process or from a record of the fakes' subprocess."""

import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402  (the repository root's card script)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.lm_family import get_config  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.launch.dryrun import batch_specs, run_cell  # noqa: E402

CPU = torch.device("cpu")
DENSE = ("qwen2.5-14b", "yi-9b")
MOE_FIELDS = {"dispatches", "dropped_share", "kept_overwritten_share",
              "experts_chosen", "experts_holding"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one torch thread a worker (see
    ``test_torch_trainer.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def is_train(arch: str, shape: str) -> bool:
    spec = get_arch(arch)
    return spec.cells(spec.config)[shape].kind == "train"


FIT_ENTRIES = [key for key, cut in C.ONE_CARD_CUTS.items()
               if cut.fit and is_train(*key)]


@pytest.mark.parametrize("arch,shape", FIT_ENTRIES,
                         ids=[f"{a}/{s}" for a, s in FIT_ENTRIES])
def test_cut_is_the_largest_that_fits(arch, shape):
    """The entry's estimate is at most FIT_LIMIT, and the next larger
    value of the field the fit rule chose is over it."""
    rule = C.fit_rule(arch, shape, CPU)
    assert rule["holds"], rule


def test_train_entries():
    """Every LM that phase 22a (b) trains has a train_4k cut with a depth
    and one sequence, and the fakes' subprocess traces each; InternLM2's
    cut (phase train_lm's) is set for time, not by the fit rule."""
    assert set(C.FULL_WIDTH_LMS) >= set(DENSE)
    assert C.TRAIN_FAKES == [(a, "train_4k") for a in C.FULL_WIDTH_LMS]
    for arch in C.FULL_WIDTH_LMS:
        cut = C.ONE_CARD_CUTS[(arch, "train_4k")]
        assert cut.fit == "layers" and cut.batch == 1 and cut.chunk == 1024
    lm = C.ONE_CARD_CUTS[(C.LM_TRAIN_ARCH, "train_4k")]
    assert (lm.batch, lm.chunk, lm.fit) == (4, 1024, None)
    assert [C.ONE_CARD_CUTS[(a, "train_4k")].layers for a in DENSE] == \
        [14, 29]


def _smoke_record(arch: str, seq: int, n_seq: int) -> tuple:
    """(cfg, specs, record): the dry run of ``arch``'s smoke config as
    :func:`chip_smoke.lm_full_width` cuts it, written as
    :func:`chip_smoke.fakes_write` writes a record."""
    cut = C.ONE_CARD_CUTS[(arch, "train_4k")]
    base = get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, n_layers=min(cut.layers, base.n_layers),
                              remat=True, attn_chunk_q=cut.chunk,
                              attn_chunk_kv=cut.chunk)
    tokens = next(synth.token_batches(C.SEED, cfg.vocab, n_seq, seq))
    specs = batch_specs({k: tokens[k] for k in ("tokens", "labels")})
    rec = run_cell(arch, "train_4k", CPU, cfg, specs=specs)
    rec.update(cfg=repr(cfg), specs=C.spec_shapes(specs))
    return cfg, specs, rec


def test_dense_full_width_on_the_cpu():
    """Phase 22a (b) over the dense LMs at their smoke configs, 2 × 64
    tokens: the loss falls, the estimate holds its tracked peak, both
    shares of the peak are reported and no MoE field stands in a dense
    row; Yi-9B's estimate comes from a record as the fakes' subprocess
    writes it, and equals the in-process one."""
    _, _, rec = _smoke_record("yi-9b", 64, 2)
    out = C.lm_full_width(CPU, DENSE, smoke=True, seq=64, lm_batch=2,
                          fakes={("yi-9b", "train_4k"): rec})
    assert set(out) == set(DENSE)
    for arch, row in out.items():
        assert not MOE_FIELDS & set(row), (arch, sorted(row))
        assert row["losses"][-1] < row["losses"][0]
        assert C.estimate_holds(row["estimate_bytes"], row["measured_bytes"])
        assert row["layers"] == row["full_layers"] == 2
        assert (row["batch"], row["seq"], row["chunk"]) == (2, 64, 1024)
        assert row["model_flops_share_of_bf16_peak"] > 0
        assert row["dryrun_flops_share_of_bf16_peak"] > 0
    assert out["yi-9b"]["estimate_bytes"] == rec["memory"]["peak_bytes"]


def test_dry_estimate_refuses_another_config_s_record():
    """A record of the fakes' subprocess made at another depth, or at
    other batch shapes, is refused, not taken as the run's estimate."""
    cfg, specs, rec = _smoke_record("qwen2.5-14b", 64, 2)
    assert C.dry_estimate("qwen2.5-14b", "train_4k", CPU, cfg, specs,
                          rec) is rec
    with pytest.raises(AssertionError, match="another config"):
        C.dry_estimate("qwen2.5-14b", "train_4k", CPU,
                       dataclasses.replace(cfg, n_layers=1), specs, rec)
    _, other, _ = _smoke_record("qwen2.5-14b", 32, 2)
    with pytest.raises(AssertionError, match="another config"):
        C.dry_estimate("qwen2.5-14b", "train_4k", CPU, cfg, other, rec)
