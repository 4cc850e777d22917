"""The port's elastic module (``repro_torch.dist.elastic``) against
``repro.dist.elastic``: the host logic bit for bit (``shrink_mesh`` and
the repartitions on the reference tests' edge cases and on hypothesis
inputs); the live split and merge through each package's Rebalancer over
the same ShardedWarren; and ``reshard`` over a real ``gloo`` group of 4
ranks, a (2, 2) mesh shrunk to (1, 2), every leaf bit for bit after
``full_tensor``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import index_document as ref_index_document  # noqa: E402
from repro.dist import elastic as JE  # noqa: E402
from repro_torch.core import index_document  # noqa: E402
from repro_torch.dist import elastic as TE  # noqa: E402

from _torch_procs import run_ranks  # noqa: E402
from test_torch_rebalance import _assert_same, _both, _ingest  # noqa: E402

SETTINGS = settings(database=None, derandomize=True, deadline=None,
                    max_examples=60)


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("sizes,lost,preserve", [
    ({"data": 4, "model": 4}, 16, "model"),
    ({"data": 1, "model": 8}, 4, "model"),
    ({"pod": 4, "data": 8, "model": 4}, 100, "model"),
    ({"pod": 2, "data": 16, "model": 16}, 256, "model"),
    ({"data": 16, "model": 16}, 1, "model"),
    ({"data": 16, "model": 16}, 0, "model"),
    ({"data": 8, "model": 2}, 3, "data"),
])
def test_shrink_mesh_edge_cases_equal_reference(sizes, lost, preserve):
    assert _outcome(TE.shrink_mesh, sizes, lost, preserve) == \
        _outcome(JE.shrink_mesh, sizes, lost, preserve)


@SETTINGS
@given(st.dictionaries(st.sampled_from(["pod", "data", "model", "x"]),
                       st.sampled_from([1, 2, 3, 4, 8, 16]), min_size=1),
       st.integers(0, 600))
def test_shrink_mesh_equals_reference(sizes, lost):
    assert _outcome(TE.shrink_mesh, sizes, lost) == \
        _outcome(JE.shrink_mesh, sizes, lost)


def test_repartition_edge_cases_equal_reference():
    shards = [[f"doc{i}" for i in range(20)],
              [f"doc{i}" for i in range(20, 50)]]
    for k in (1, 2, 3, 7, 64):
        assert TE.repartition_shards(shards, k) == \
            JE.repartition_shards(shards, k)
        assert len(TE.repartition_shards(shards, k)) == k
    assert TE.repartition_shards([[]], 4) == [[], [], [], []]
    for bad in (0, -1):
        assert _outcome(TE.repartition_shards, shards, bad) == \
            _outcome(JE.repartition_shards, shards, bad)
    with pytest.raises(ValueError, match="returned 5"):
        TE.repartition_shards(shards, 3, route=lambda item, k: 5)
    assert _outcome(TE.repartition_replica_groups, shards, 3, 0) == \
        _outcome(JE.repartition_replica_groups, shards, 3, 0)
    got = TE.repartition_replica_groups(shards, 5, replicas=3)
    assert got == JE.repartition_replica_groups(shards, 5, replicas=3)
    assert all(g[0] is not g[1] for g in got)      # independent lists


@SETTINGS
@given(st.lists(st.lists(st.one_of(st.integers(-10**6, 10**6),
                                   st.text(max_size=6),
                                   st.tuples(st.integers(0, 9),
                                             st.text(max_size=3))),
                         max_size=12), max_size=5),
       st.integers(1, 9), st.integers(1, 3))
def test_repartitions_equal_reference(shards, k, replicas):
    assert TE.repartition_shards(shards, k) == \
        JE.repartition_shards(shards, k)
    assert TE.repartition_replica_groups(shards, k, replicas) == \
        JE.repartition_replica_groups(shards, k, replicas)


def test_split_then_merge_through_elastic_matches_reference():
    """``split_shard_group`` and ``merge_shard_groups`` of each package on
    the same warren: the same new group, routing, floors and lists."""
    ref, port = _both(n_docs=100)
    gid = [JE.split_shard_group(ref, 0), TE.split_shard_group(port, 0)]
    assert gid[0] == gid[1] == 2
    _assert_same(ref, port)
    _ingest(ref, ref_index_document, range(700, 720))
    _ingest(port, index_document, range(700, 720))
    JE.merge_shard_groups(ref, 0, gid[0])
    TE.merge_shard_groups(port, 0, gid[1])
    assert port.groups[gid[1]].retired
    _ingest(ref, ref_index_document, range(800, 830))
    _ingest(port, index_document, range(800, 830))
    _assert_same(ref, port, (":", "docid:d0", "docid:d705", "docid:d820"))


def test_split_and_merge_report_through_a_callers_rebalancer():
    """With ``rebalancer=``, the split's and the merge's stats land in the
    caller's Rebalancer, as the Rebalancer's own calls leave them; a pool
    beside it, or a Rebalancer over another warren, is refused."""
    from repro_torch.dist.rebalance import Rebalancer
    _, port = _both(n_docs=100)
    reb = Rebalancer(port)
    new = TE.split_shard_group(port, 0, rebalancer=reb)
    split = reb.last_stats
    assert (split.kind, split.source, split.dest) == ("split", 0, new)
    assert split.swap_s >= 0 and split.segments_streamed > 0
    TE.merge_shard_groups(port, 0, new, rebalancer=reb)
    merge = reb.last_stats
    assert merge.kind.startswith("merge") and len(reb.history) == 2
    assert (merge.dest, merge.source) == (0, new) and merge.swap_s >= 0
    _, other = _both(n_docs=10)
    with pytest.raises(ValueError):
        TE.split_shard_group(other, 0, rebalancer=reb)
    with pytest.raises(ValueError):
        TE.merge_shard_groups(port, 0, 1, pool=object(), rebalancer=reb)


def test_copied_functions_are_bound_to_impl_definitions():
    """Rule (m): each public name is an ``_impl`` definition's."""
    for name in ("reshard", "shrink_mesh", "repartition_shards",
                 "repartition_replica_groups", "split_shard_group",
                 "merge_shard_groups"):
        assert getattr(TE, name).__name__ == f"_{name}_impl"
    assert not hasattr(TE, "autopilot")


RESHARD = """
import sys, numpy as np, torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch.mesh import file_process_group, make_mesh_from_sizes
from repro_torch.dist import elastic, sharding as shd
rank, n, init, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
rng = np.random.default_rng(0)
state = {"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)),
         "opt": {"mu": torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32)),
                 "step": torch.tensor(7, dtype=torch.int32)},
         "emb": torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)).bfloat16()}
with file_process_group("gloo", n, rank, init):
    sizes = {"data": 2, "model": 2}
    mesh = make_mesh_from_sizes(sizes, device_type="cpu")
    before = {"w": shd.placements(mesh, ("data", "model")),
              "opt": {"mu": shd.placements(mesh, (None, "model")),
                      "step": shd.placements(mesh, ())},
              "emb": shd.placements(mesh, ("model",))}
    on = elastic.reshard(state, before, mesh)
    assert tuple(on["w"].to_local().shape) == (4, 3)
    # same mesh: redistribute
    moved = elastic.reshard(on, {"w": shd.placements(mesh, ("model", "data")),
                                 "opt": {"mu": shd.placements(mesh, ("data",)),
                                         "step": shd.placements(mesh, ())},
                                 "emb": shd.placements(mesh, (None, "data"))})
    assert moved["w"].device_mesh == mesh
    # the elastic restart: two devices lost
    small = elastic.shrink_mesh(sizes, 2)
    assert small == {"data": 1, "model": 2}
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    # the survivors' mesh, ranks 0 and 1 (every rank builds it: its groups
    # are made collectively; ranks 2 and 3 hold nothing of it)
    new = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                     mesh_dim_names=tuple(small))
    whole = {"w": moved["w"].full_tensor(),
             "mu": moved["opt"]["mu"].full_tensor(),
             "emb": moved["emb"].full_tensor()}
    after = elastic.reshard(moved, {
        "w": shd.placements(new, (None, "model")),
        "opt": {"mu": shd.placements(new, ("model",)),
                "step": shd.placements(new, ())},
        "emb": shd.placements(new, ("model",))}, new)
    out = {}
    if rank < 2:
        assert tuple(after["w"].to_local().shape) == (8, 3)
        out = {"w": after["w"].full_tensor(), "mu": after["opt"]["mu"].full_tensor(),
               "step": after["opt"]["step"].full_tensor(),
               "emb": after["emb"].full_tensor()}
    dist.barrier()
np.savez(f"{work}/r{rank}.npz", **{k: v.float().numpy() for k, v in whole.items()},
         **{f"after_{k}": v.float().numpy() for k, v in out.items()})
"""


def test_reshard_onto_a_shrunk_mesh_on_gloo(tmp_path):
    """4 ranks over (2, 2), resharded on the same mesh, then onto the
    (1, 2) mesh that ``shrink_mesh`` gives after losing 2 devices (its
    two ranks): every leaf bit for bit with the state it started from,
    bf16 included."""
    run_ranks(RESHARD, 4, tmp_path)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    mu = rng.standard_normal((4, 12)).astype(np.float32)
    emb = torch.from_numpy(rng.standard_normal((16, 4)).astype(
        np.float32)).bfloat16().float().numpy()
    for rank in range(4):
        got = np.load(tmp_path / f"r{rank}.npz")
        for key, want in (("w", w), ("mu", mu), ("emb", emb)):
            assert got[key].tobytes() == want.tobytes()
            if rank < 2:
                assert got[f"after_{key}"].tobytes() == want.tobytes()
        if rank < 2:
            assert got["after_step"] == 7
