"""The one-card dry run (``repro_torch.launch.dryrun``) on CPU fakes: the
dense LM cells at full width, hand counts of a train and a decode step's
FLOPs, the launcher, and ``chip_smoke.py``'s phase ``dryrun`` on the CPU
at small configs (the real step against its estimate, and the check
refusing a wrong one).  The MoE, recsys and GNN cells are in the sibling
files ``test_torch_dryrun_{moe,qwen3,recsys,gnn}.py``."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repository root's card script)
from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

DENSE = ("qwen2.5-14b", "yi-9b", "internlm2-1.8b")


def cells_of(*archs):
    return [(a, s) for a, s, _ in all_cells() if a in archs]


def check_cell(arch, shape):
    """A cell's dry run on CPU fakes: it runs, counts FLOPs, and its peak
    holds at least its arguments."""
    rec = dryrun.run_cell(arch, shape, "cpu")
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "cpux1" and rec["n_devices"] == 1
    assert rec["collectives"] == {}
    mem = rec["memory"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["peak_bytes"] >= (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"]) - dryrun.GRANULE
    assert rec["fits"] == (mem["peak_bytes"] <= rec["capacity_bytes"])
    return rec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", cells_of(*DENSE),
                         ids=[f"{a}/{s}" for a, s in cells_of(*DENSE)])
def test_dense_lm_cell_on_cpu_fakes(arch, shape):
    check_cell(arch, shape)


def _smoke_counts():
    cfg = get_arch("internlm2-1.8b").smoke_config
    l, d, h, hkv = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh, f, v = cfg.head_dim, cfg.d_ff, cfg.vocab
    # the weights a token meets in products: q, k, v, o, the SwiGLU's
    # three, and the LM head
    p = l * (d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * f) + d * v
    return cfg, l, h, dh, p


def test_train_step_flops_by_hand():
    """train_4k at the smoke config (no remat, full attention): the
    forward's products 2·T·P plus q·K and P·V over every S² pair and head,
    and a backward of twice that (both operands of every product need a
    gradient); AdamW and the norms count none."""
    cfg, l, h, dh, p = _smoke_counts()
    b, s = 256, 4096
    assert not cfg.remat and not cfg.attn_chunk_q
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", "cpu", cfg)
    assert rec["ok"], rec.get("traceback")
    assert rec["cost"]["flops"] == 3 * (2 * b * s * p
                                        + l * 4 * b * h * s * s * dh)


def test_decode_step_flops_by_hand():
    """decode_32k at the smoke config: 2·B·P for the new tokens, and
    gqa_decode's formula 4·B·Hkv·G·S·D a layer over the full cache."""
    cfg, l, h, dh, p = _smoke_counts()
    b, s = 128, 32_768
    rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", "cpu", cfg)
    assert rec["ok"], rec.get("traceback")
    assert rec["cost"]["flops"] == 2 * b * p + l * 4 * b * h * s * dh
    assert rec["cache_bytes"] == 2 * l * b * s * cfg.n_kv_heads * dh * 4 \
        + dryrun.GRANULE


def test_main_writes_a_record(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--device", "cpu", "--arch", "nequip", "--shape",
                        "molecule", "--out", str(out)]) == 0
    (line,) = out.read_text().splitlines()
    rec = json.loads(line)
    assert (rec["arch"], rec["shape"], rec["ok"]) == ("nequip", "molecule",
                                                      True)
    assert "traceback" not in rec
    assert "1/1 cells traced on cpux1" in capsys.readouterr().out


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "nequip", "--shape", "molecule"])


def _small_configs():
    lm = dataclasses.replace(get_arch("internlm2-1.8b").smoke_config,
                             n_layers=3)
    # Yi-9B's smoke config has one KV head to InternLM2-1.8B's two: 6
    # layers give its long_500k cache the same 402 MB
    yi = dataclasses.replace(get_arch("yi-9b").smoke_config, n_layers=6)
    return {"internlm2-1.8b": lm, "yi-9b": yi,
            "dlrm-rm2": get_arch("dlrm-rm2").smoke_config,
            "nequip": get_arch("nequip").smoke_config}


def test_chip_smoke_dryrun_on_the_cpu():
    """Phase ``dryrun`` with the CPU as the device, at small configs: the
    real step's tracked peak and FLOPs equal the fakes', and the estimate
    without long_500k's KV cache (402 MB in both LMs) is refused."""
    cells = {cell: {} for cell in chip_smoke.DRYRUN_CELLS}
    out = chip_smoke.phase_dryrun(torch.device("cpu"), cells,
                                  configs=_small_configs())
    assert set(out) == {f"{a}/{s}" for a, s in chip_smoke.DRYRUN_CELLS}
    for row in out.values():
        assert row["estimate_bytes"] == row["measured_bytes"]
        assert row["flops"] == row["real_flops"] > 0
    assert out["internlm2-1.8b/long_500k"]["without_cache_refused"]
    assert out["yi-9b/long_500k"]["without_cache_refused"]


def test_chip_smoke_dryrun_refuses_a_wrong_estimate(monkeypatch):
    """The memory check refuses an estimate 6 % under the real step's (its
    256 MiB floor set to 0: the smoke table is far smaller), and the FLOP
    check a count off by one."""
    real_run = dryrun.run_cell
    cell = {("dlrm-rm2", "serve_p99"): {}}
    small = {"dlrm-rm2": get_arch("dlrm-rm2").smoke_config}
    monkeypatch.setattr(chip_smoke, "DRYRUN_FLOOR", 0)

    def under(*args, **kwargs):
        rec = real_run(*args, **kwargs)
        if kwargs.get("seed") is None:
            rec["memory"]["peak_bytes"] *= 0.94
        return rec
    monkeypatch.setattr(dryrun, "run_cell", under)
    with pytest.raises(AssertionError, match="estimate"):
        chip_smoke.phase_dryrun(torch.device("cpu"), cell, configs=small)

    def off_by_one(*args, **kwargs):
        rec = real_run(*args, **kwargs)
        if kwargs.get("seed") is None:
            rec["cost"]["flops"] += 1
        return rec
    monkeypatch.setattr(dryrun, "run_cell", off_by_one)
    with pytest.raises(AssertionError, match="FLOPs"):
        chip_smoke.phase_dryrun(torch.device("cpu"), cell, configs=small)


def test_chip_smoke_dispatch_cost_on_the_cpu():
    out = chip_smoke.dispatch_cost(torch.device("cpu"), calls=3)
    assert set(out) == {"gqa_decode", "embedding_bag"}
    for row in out.values():
        assert len(row["op_us"]) == len(row["body_us"]) == 2
        assert min(row["op_us"] + row["body_us"]) > 0


def test_estimate_holds_bounds():
    gib = 1 << 30
    assert chip_smoke.estimate_holds(57 * gib, 57.5 * gib)
    assert not chip_smoke.estimate_holds(3.8 * gib, 55.3 * gib)
    assert chip_smoke.estimate_holds(0.9 * gib, 0.7 * gib)       # 256 MiB
    assert not chip_smoke.estimate_holds(1.0 * gib, 0.7 * gib)
