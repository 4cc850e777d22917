"""The dry run on a mesh (``repro_torch.launch.dryrun`` with ``mesh=``):
``chip_smoke.py``'s phase ``dist`` (d) cells at full width on a fake 4×2
``("data", "model")`` group of 8 ranks, on CPU fakes.

Each record must be ``ok``; each device's argument bytes (parameters,
optimizer state, batch and cache, before the 512-byte granule) must equal
the sum of the reference's ``build_cell`` shardings' shard shapes on a
(4, 2) mesh (a subprocess on forced host devices); a train step must move
collectives; and one hand-counted case: a column-sharded product gathered
whole is one all-gather of the product's bytes.
"""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

from _torch_procs import run_reference  # noqa: E402

CELLS = [("internlm2-1.8b", "train_4k"), ("qwen3-moe-235b-a22b", "decode_32k"),
         ("dlrm-rm2", "train_batch"), ("nequip", "minibatch_lg")]

REF = """
import json, sys, math
import jax
from repro.launch.dryrun import build_cell
work = sys.argv[1]
mesh = jax.make_mesh((4, 2), ("data", "model"))
out = {}
for arch, shape in json.loads(open(work + "/cells.json").read()):
    fn, args, in_sh, out_sh, meta = build_cell(arch, shape, mesh, "auto")
    leaves = jax.tree.leaves(args)
    shards = jax.tree.leaves(in_sh)
    assert len(leaves) == len(shards)
    out[arch + ":" + shape] = sum(
        math.prod(s.shard_shape(tuple(a.shape))) * a.dtype.itemsize
        for a, s in zip(leaves, shards))
open(work + "/ref.json", "w").write(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    with M.fake_process_group(8):
        mesh = M.make_mesh_from_sizes({"data": 4, "model": 2},
                                      device_type="cpu")
        return {(a, s): dryrun.run_cell(a, s, "cpu", mesh=mesh)
                for a, s in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}:{s}" for a, s in CELLS])
def test_cell_runs_on_the_mesh(records, cell):
    rec = records[cell]
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "pod4x2" and rec["n_devices"] == 8
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["argument_bytes"] >= rec["argument_exact_bytes"]
    assert rec["cost"]["flops"] > 0
    if rec["kind"] == "train":
        assert rec["collectives"], "a sharded train step moves no bytes?"
        assert all(v["count"] > 0 and v["bytes"] > 0
                   for v in rec["collectives"].values())
    assert rec["fits"] == (mem["peak_bytes"] <= rec["capacity_bytes"])
    assert rec.get("layer_axis_leaves", {}) == {}


def test_argument_bytes_equal_the_reference_shards(records, tmp_path):
    (tmp_path / "cells.json").write_text(json.dumps(CELLS))
    run_reference(REF, 8, tmp_path, timeout=600)
    want = json.loads((tmp_path / "ref.json").read_text())
    for (arch, shape), rec in records.items():
        assert rec["argument_exact_bytes"] == want[f"{arch}:{shape}"], \
            (arch, shape)


def test_one_hand_counted_all_gather():
    """x [8, 16] whole on every rank times w [16, 32] cut by columns over
    ``model``, gathered whole: one all-gather whose result is the whole
    [8, 32] float32 product, 1,024 bytes a device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with M.fake_process_group(8):
        mesh = M.make_mesh_from_sizes({"data": 4, "model": 2},
                                      device_type="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 16), mesh,
                                  [Replicate(), Replicate()])
            w = distribute_tensor(torch.empty(16, 32), mesh,
                                  [Replicate(), Shard(1)])
            comms = dryrun.Collectives()
            live = dryrun.LiveBytes(torch.device("cpu"))
            with dryrun.shadow_ops_hidden(), comms, live:
                y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
            assert tuple(y.to_local().shape) == (8, 32)
    assert comms.stats == {"all-gather": {"count": 1, "bytes": 1024.0}}


def test_main_on_the_production_mesh_writes_records(tmp_path, capsys):
    """The launcher on the 16×16 mesh (256 fake ranks) at one recsys cell:
    its record names the mesh and the fsdp mode, and no group is left."""
    import torch.distributed as dist
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--device", "cpu", "--production", "--cell",
                        "dlrm-rm2:serve_p99", "--fsdp", "on",
                        "--out", str(out)]) == 0
    assert not dist.is_initialized()
    (line,) = out.read_text().splitlines()
    rec = json.loads(line)
    assert (rec["mesh"], rec["n_devices"], rec["ok"]) == ("pod16x16", 256,
                                                          True)
    assert "1/1 cells traced on pod16x16" in capsys.readouterr().out


def test_chip_smoke_dist_phase_on_cpu(capsys):
    """``chip_smoke.py``'s phase ``dist`` on the host: the wide G and D
    cases, the DTensor decode on one ``gloo`` rank at the smoke config
    (logits bit for bit with the plain decode), the cross-pod reduce on a
    one-rank pod mesh, and the production dry run's subprocess at one
    recsys cell."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    cfg = get_arch("internlm2-1.8b").smoke_config
    out = chip_smoke.phase_dist(torch.device("cpu"), cfg=cfg, prompt=6,
                                max_new=3, cells=[("dlrm-rm2", "serve_p99")])
    assert not dist.is_initialized()
    assert out["decode"]["steps"] == 8
    assert out["decode"]["logits_bit_equal_steps"] == 8
    assert out["cross_pod"]["bit_equal"]
    rec = out["dryrun"]["dlrm-rm2:serve_p99"]
    assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
    assert '"phase": "dist_dryrun"' in capsys.readouterr().out


@pytest.mark.parametrize("moe_shard", ["all", "combine"])
def test_moe_shard_constraints_redistribute_on_a_mesh(moe_shard):
    """The reference's ``moe_shard`` constraints as redistributes inside
    ``moe_block``: the MoE smoke config decodes on a 4×2 mesh with each
    (``"all"`` moves the expert buffers: more collectives than with none);
    a constraint's placements are the spec's on the mesh, the axes the
    mesh lacks left out; off a mesh nothing changes."""
    import dataclasses
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("qwen3-moe-235b-a22b").smoke_config
    shaped = dataclasses.replace(cfg, moe_shard=moe_shard)
    with M.fake_process_group(8):
        mesh = M.make_mesh_from_sizes({"data": 4, "model": 2},
                                      device_type="cpu")
        recs = [dryrun.run_cell("qwen3-moe-235b-a22b", "decode_32k", "cpu",
                                cfg=c, mesh=mesh) for c in (cfg, shaped)]
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 4, 6), mesh,
                                  [Replicate(), Replicate()])
            assert T._constrain(x, ("model", "data", None)).placements \
                == (Shard(1), Shard(0))
            assert T._constrain(x, ("pod", "data", None)).placements \
                == (Shard(1), Replicate())
    assert all(r["ok"] for r in recs), [r.get("error") for r in recs]
    count = [sum(v["count"] for v in r["collectives"].values())
             for r in recs]
    if moe_shard == "all":
        assert count[1] > count[0]
    x = torch.randn(4, 3)
    assert T._constrain(x, ("model", "data", None)) is x
