"""Fault (x): on some DTensor versions the MoE cells of the production dry
run did not trace, with "redistribute from S(d) to P(sum) not supported
yet".  DTensor's add of a pending sum (``Partial``) and a cut (``Shard``)
on one mesh dimension asked to turn the cut into a pending sum: in the
forward where the shared expert's output meets the routed experts' (and
the attention output meets the residual stream), and in the backward
where autograd adds the gradients of a tensor used several times (the
MoE input, the normed input of the q/k/v products).

The model code now reduces such a pending sum before it adds
(``on_mesh.add_settled``) and gives each use of such a tensor its own
``grad_like``.  These tests hold that on CPU fakes: the
helper on a fake mesh, plain tensors untouched, and the first cell that
failed on the card traced here at full width on the 16×16 mesh.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa
                                      Shard)
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.dist.on_mesh import add_settled, grad_like  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


def test_plain_tensors_take_the_plain_add():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(5, 7, generator=g), torch.randn(5, 7, generator=g)
    assert torch.equal(add_settled(a, b), a + b)
    assert grad_like(a) is a


@pytest.mark.parametrize("pa,pb,all_reduces", [
    # the forward's case: the shared expert's pending sum on model meets
    # the routed output cut on model
    ((Shard(1), Partial()), (Replicate(), Shard(1)), 1),
    # the backward's: each operand pending where the other is cut
    ((Partial(), Shard(2)), (Shard(2), Partial()), 2),
    # nothing pending against a cut: added as it is
    ((Shard(0), Replicate()), (Shard(0), Shard(1)), 0)])
def test_add_settled_reduces_a_pending_sum_that_meets_a_cut(pa, pb,
                                                            all_reduces):
    shape, sizes = (8, 16, 32), (4, 2)
    with M.fake_process_group(8):
        mesh = M.make_mesh_from_sizes({"data": 4, "model": 2},
                                      device_type="cpu")
        with FakeTensorMode():
            def local(places):
                loc = list(shape)
                for p, n in zip(places, sizes):
                    if isinstance(p, Shard):
                        loc[p.dim] //= n
                return DTensor.from_local(torch.zeros(loc), mesh,
                                          list(places), run_check=False,
                                          shape=shape, stride=(512, 32, 1))

            with CommDebugMode() as comm:
                out = add_settled(local(pa), local(pb))
            counts = comm.get_comm_counts()
            n = sum(v for k, v in counts.items()
                    if "all_reduce" in str(k))
            assert n == all_reduces, counts
            assert not any("reduce_scatter" in str(k) for k in counts)
            assert isinstance(out, DTensor) and tuple(out.shape) == shape


@pytest.mark.parametrize("cell", [("qwen2-moe-a2.7b", "train_4k")],
                         ids=["qwen2-moe-a2.7b:train_4k"])
def test_the_fault_x_cell_traces_on_cpu_fakes(cell):
    arch, shape = cell
    with M.fake_process_group(256):
        mesh = M.make_production_mesh(device_type="cpu")
        rec = dryrun.run_cell(arch, shape, "cpu", mesh=mesh,
                              fsdp_mode="auto")
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"] and all(
        v["count"] > 0 for v in rec["collectives"].values())
    assert 0 < rec["memory"]["argument_bytes"] <= rec["memory"]["peak_bytes"]
