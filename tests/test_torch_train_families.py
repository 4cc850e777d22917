"""``chip_smoke.py``'s phase ``train_families`` on the CPU at small sizes:
both MoE configs and NequIP's two tasks trained on the "card" (the CPU)
against the host, the launcher on five archs, and the full-width runs at
the MoE smoke configs and small graphs, each held to its dry-run
estimate; the card-against-host check refusing a run whose forces give
the parameters no gradient, and the fit check refusing an estimate over
its limit.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repository root's card script)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.gnn_family import (NEQUIP, NEQUIP_SMOKE,  # noqa
                                            cfg_for_cell)
from repro_torch.data.synth import NeighborSampler, random_graph  # noqa
from repro_torch.launch.dryrun import batch_specs, run_cell  # noqa: E402
from repro_torch.models import nequip as NQ  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one torch thread a worker (see
    ``test_torch_trainer.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parent(n: int = 3_000, e: int = 150_000) -> dict:
    cfg = cfg_for_cell(NEQUIP, "minibatch_lg")
    g = random_graph(0, n, e, d_feat=cfg.d_feat, n_classes=cfg.n_classes)
    return {"graph": g,
            "sampler": NeighborSampler(n, g["senders"], g["receivers"])}


def test_chip_smoke_train_families_on_the_cpu():
    """The phase at the LMs' smoke configs (2 sequences of 64 tokens) and
    NequIP's full config on small graphs: every check holds, the MoE
    dispatch runs twice a layer and step (remat), the launcher trains each
    arch 3 steps, and each full-width run's estimate is its tracked peak's
    within the dry run's rule."""
    out = chip_smoke.phase_train_families(
        CPU, parent=_parent(), smoke=True, seq=64, lm_batch=2, seeds=64,
        molecules=(6, 30, 64), full_graph=(300, 1_200))
    assert set(out["card_vs_host"]) == {
        "qwen2-moe-a2.7b/lm", "qwen3-moe-235b-a22b/lm", "nequip/classify",
        "nequip/molecule"}
    for arch in chip_smoke.LAUNCHED_ARCHS:
        row = out["launcher"][arch]
        assert row["steps"] == chip_smoke.FAMILY_STEPS
        assert row["launches"] == (0, 0)           # no kernel on the host
    full = out["full_width"]
    assert set(full) == {"qwen2.5-14b", "yi-9b", "qwen2-moe-a2.7b",
                         "qwen3-moe-235b-a22b", "nequip/minibatch_lg",
                         "nequip/molecule", "nequip/full_graph_sm"}
    for arch in ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"):
        row = full[arch]
        assert row["full_layers"] == 2
        assert row["layers"] == min(
            2, chip_smoke.ONE_CARD_CUTS[(arch, "train_4k")].layers)
        assert row["dispatches"] == 2 * row["layers"] * row["steps"]
        assert 0.0 <= row["dropped_share"] < 1.0
    for row in full.values():
        assert row["losses"][-1] < row["losses"][0]
        assert chip_smoke.estimate_holds(row["estimate_bytes"],
                                         row["measured_bytes"])
    mb = full["nequip/minibatch_lg"]
    assert 64 * 15 < mb["edges"] <= 64 * 15 + 64 * 15 * 10
    assert mb["host_sample_ms"] > 0
    assert full["nequip/full_graph_sm"]["nodes"] == 300


def _detached_forces(calls: list, n_degraded: int):
    """``energy_and_forces`` whose first ``n_degraded`` calls compute the
    forces with ``create_graph=False``: the energies keep their graph, the
    forces are constants, so a force loss gives the parameters no
    gradient."""
    real = NQ.energy_and_forces

    def wrong(model, positions, species, senders, receivers,
              graph_ids=None, n_graphs=1, create_graph=False):
        calls.append(1)
        if len(calls) > n_degraded:
            return real(model, positions, species, senders, receivers,
                        graph_ids, n_graphs, create_graph=create_graph)
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = NQ.energy_fn(model, pos, species, senders, receivers,
                             graph_ids, n_graphs)
            (g,) = torch.autograd.grad(e.sum(), pos, retain_graph=True)
        return e, -g.detach()
    return wrong


def test_card_vs_host_refuses_forces_without_their_gradient(monkeypatch):
    """3 molecule steps whose forces on the "card" carry no gradient fail
    the card-against-host bound; the same steps with the forces'
    gradient pass it."""
    cfg = cfg_for_cell(NEQUIP_SMOKE, "molecule")
    spec = get_arch("nequip")
    batches = [spec.smoke_batch(cfg, "train", s)
               for s in range(chip_smoke.FAMILY_STEPS)]
    chip_smoke.family_card_vs_host(CPU, "nequip", cfg, batches, "right")
    calls = []
    monkeypatch.setattr(NQ, "energy_and_forces",
                        _detached_forces(calls, len(batches)))
    with pytest.raises(AssertionError, match="degraded"):
        chip_smoke.family_card_vs_host(CPU, "nequip", cfg, batches,
                                       "degraded")
    assert len(calls) == 3 * len(batches)          # card, host32, host64


@pytest.mark.parametrize("arch,shape", [("xdeepfm", "train_batch"),
                                         ("nequip", "molecule")])
def test_dry_estimate_refuses_a_run_over_the_fit_limit(arch, shape,
                                                        monkeypatch):
    """The full-width runs' fit check: an estimate at FIT_LIMIT passes, the
    same estimate one byte over it is refused."""
    spec = get_arch(arch)
    cfg = (cfg_for_cell(NEQUIP_SMOKE, shape) if arch == "nequip"
           else spec.smoke_config)
    specs = batch_specs(spec.smoke_batch(cfg, "train", 0))
    rec = chip_smoke.dry_estimate(arch, shape, CPU, cfg, specs)
    peak = rec["memory"]["peak_bytes"]
    monkeypatch.setattr(chip_smoke, "FIT_LIMIT", peak)
    assert chip_smoke.dry_estimate(arch, shape, CPU, cfg, specs)[
        "memory"]["peak_bytes"] == peak
    monkeypatch.setattr(chip_smoke, "FIT_LIMIT", peak - 1)
    with pytest.raises(AssertionError, match="over"):
        chip_smoke.dry_estimate(arch, shape, CPU, cfg, specs)


def test_batch_specs_give_the_run_s_shapes():
    """``run_cell`` at a sampled graph's own shapes: the real step's tracked
    peak and FLOPs equal the fakes' (the scalar graph count is left out)."""
    cfg = cfg_for_cell(NEQUIP_SMOKE, "minibatch_lg")
    b = random_graph(1, 200, 900, d_feat=cfg.d_feat, n_classes=cfg.n_classes)
    specs = batch_specs(dict(b, n_graphs=3))
    assert set(specs) == set(b)
    assert specs["positions"].shape == (200, 3)
    assert specs["senders"].dtype == torch.int32
    fake = run_cell("nequip", "minibatch_lg", CPU, NEQUIP_SMOKE, specs=specs)
    real = run_cell("nequip", "minibatch_lg", CPU, NEQUIP_SMOKE, seed=0,
                    specs=specs)
    assert fake["ok"] and real["ok"]
    assert fake["memory"]["peak_bytes"] == real["memory"]["peak_bytes"]
    assert fake["cost"]["flops"] == real["cost"]["flops"] > 0
