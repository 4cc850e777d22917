"""The port's meshes and sharding policies (``repro_torch.launch.mesh``,
``repro_torch.dist.sharding``) against the reference's ``NamedSharding``s.

The reference's policies run as they are on a ``jax.sharding.
AbstractMesh`` of the production shapes; the port's on a ``DeviceMesh``
over a fake process group of 256 or 512 ranks.  Every parameter of the 10
architectures is compared, spec and shard shape, on both production
meshes and every ``--fsdp`` mode.  The port keeps one tensor a transformer
layer where the reference stacks them on [L]: the leaves whose stacked
form the reference shards along L are the documented difference (7, all
under ``--fsdp on`` on 16×16), asserted as such.  Then the cache, batch
and optimizer-state policies, and on a 2×2×2 mesh every rank's slice
against the reference's ``devices_indices_map`` on 8 forced host devices
(a subprocess).
"""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs.gnn_family import cfg_for_cell as jcfg_for_cell  # noqa
from repro.dist import sharding as JS  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.gnn_family import cfg_for_cell  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

from _torch_procs import run_reference  # noqa: E402

MESHES = {"pod16x16": (False, (16, 16), ("data", "model")),
          "pod2x16x16": (True, (2, 16, 16), ("pod", "data", "model"))}
# (arch, leaf): the leaves the reference shards along L, all on 16×16
# under --fsdp on (ROADMAP: the per-layer difference)
L_AXIS = {("qwen2.5-14b", leaf) for leaf in
          ("attn_norm", "mlp_norm", "bq", "bk", "bv")} | {
    ("yi-9b", "attn_norm"), ("yi-9b", "mlp_norm")}


def _norm(spec, ndim):
    """A jax PartitionSpec or a port spec as a tuple of ndim entries, one
    axis as its name, several as a tuple."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _local_shape(mesh, shape, places):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        tuple(shape), mesh, list(places))[0])


def _reference(arch, jmesh, fsdp):
    spec = JARCHS[arch]
    if spec.family == "lm":
        params = spec.abstract_params()
        return params, JS.lm_param_sharding(jmesh, params, fsdp=fsdp)
    if spec.family == "gnn":
        import jax
        cfg = jcfg_for_cell(spec.config, "minibatch_lg")
        params = jax.eval_shape(lambda k: spec.init_fn(cfg, k),
                                jax.random.PRNGKey(0))
        return params, JS.gnn_param_sharding(jmesh, params)
    params = spec.abstract_params()
    return params, JS.recsys_param_sharding(jmesh, params)


def _port(arch, mesh, fsdp):
    spec = get_arch(arch)
    if spec.family == "lm":
        model = spec.abstract_params()
        return model, shd.lm_param_sharding(mesh, model, fsdp=fsdp)
    if spec.family == "gnn":
        model = spec.abstract_params(cfg_for_cell(spec.config,
                                                  "minibatch_lg"))
        return model, shd.gnn_param_sharding(mesh, model)
    model = spec.abstract_params()
    return model, shd.recsys_param_sharding(mesh, model)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_every_parameter_placed_as_the_reference(mesh_name):
    multi_pod, shape, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    differ = set()
    n = 0
    with M.fake_process_group(int(np.prod(shape))):
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh.mesh_dim_names == axes
        assert tuple(mesh.mesh.shape) == shape
        for arch in JARCHS:
            family = JARCHS[arch].family
            for fsdp_mode in ("auto", "on", "off"):
                fsdp = (JARCHS[arch].config.moe is not None
                        if fsdp_mode == "auto" else fsdp_mode == "on") \
                    if family == "lm" else False
                jparams, jsh = _reference(arch, jmesh, fsdp)
                model, places = _port(arch, mesh, fsdp)
                named = dict(model.named_parameters())
                jleaves = dict(_flat(jparams))
                jshard = dict(_flat(jsh))
                for name, leaf in jleaves.items():
                    want = _norm(jshard[name].spec, len(leaf.shape))
                    if family == "lm" and name.startswith("layers."):
                        lname = name.split(".", 1)[1]
                        if want[0] is not None:
                            differ.add((arch, lname, fsdp_mode))
                            assert (arch, lname) in L_AXIS
                            info = shd.layer_axis_leaves(mesh, model, fsdp)
                            assert info[lname]["reference"] == want
                            continue
                        keys = [f"layers.{i}.{lname}"
                                for i in range(leaf.shape[0])]
                        want, shape1 = want[1:], leaf.shape[1:]
                    else:
                        keys, shape1 = [name], leaf.shape
                    wshard = jshard[name].shard_shape(tuple(leaf.shape))
                    wshard = wshard[1:] if len(keys) > 1 or (
                        family == "lm" and name.startswith("layers.")) \
                        else wshard
                    for key in keys:
                        assert tuple(named[key].shape) == tuple(shape1)
                        got = shd.placement_spec(mesh, places[key],
                                                 len(shape1))
                        assert got == want, (arch, fsdp_mode, key)
                        assert _local_shape(mesh, shape1, places[key]) \
                            == tuple(wshard), (arch, key)
                        n += 1
                assert set(named) == {k for name in jleaves
                                      for k in ([name] if not (
                                          family == "lm"
                                          and name.startswith("layers."))
                                          else [f"layers.{i}.{name[7:]}"
                                                for i in range(
                                                    jleaves[name].shape[0])])}
    assert n > 1000
    if mesh_name == "pod16x16":
        assert {(a, leaf) for a, leaf, mode in differ} == L_AXIS
        assert {mode for *_, mode in differ} == {"on"}
    else:
        assert not differ


def test_layer_axis_leaves_and_their_bytes():
    """The seven leaves, each replicated on ``data`` in the port: a
    device holds all L of its per-layer shards where the reference holds
    L / 16 layers of the same shard."""
    with M.fake_process_group(256):
        mesh = M.make_production_mesh(device_type="cpu")
        total = 0
        for arch in ("qwen2.5-14b", "yi-9b"):
            model = get_arch(arch).abstract_params()
            info = shd.layer_axis_leaves(mesh, model, fsdp=True)
            assert not shd.layer_axis_leaves(mesh, model, fsdp=False)
            cfg = model.cfg
            for leaf, rec in info.items():
                width = dict(model.layers[0].named_parameters())[leaf].numel()
                assert rec["port"] == ("model",)
                assert rec["reference"] == ("data", "model")
                assert rec["extra_bytes"] == 2 * (
                    cfg.n_layers * width // 16
                    - cfg.n_layers // 16 * width // 16)
            total += len(info)
        assert total == 7


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_batch_and_optimizer_policies(mesh_name):
    multi_pod, shape, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    with M.fake_process_group(int(np.prod(shape))):
        mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert shd.data_axes(mesh) == JS.data_axes(jmesh)
        for batch, long_ctx in ((128, False), (1, True), (3, False),
                                (32, False), (512, False)):
            want = JS.lm_cache_sharding(jmesh, batch, long_context=long_ctx)
            got = shd.lm_cache_sharding(mesh, batch, long_context=long_ctx)
            for key, nd in (("k", 5), ("v", 5), ("length", 1)):
                assert shd.placement_spec(mesh, got[key], nd) == \
                    _norm(want[key].spec, nd), (batch, key)
        assert shd.placement_spec(mesh, shd.recsys_batch_sharding(mesh),
                                  2) == _norm(
            JS.recsys_batch_sharding(jmesh).spec, 2)
        jparams, jsh = _reference("dlrm-rm2", jmesh, False)
        model, places = _port("dlrm-rm2", mesh, False)
        jopt = JS.opt_state_sharding(jsh)
        opt = shd.opt_state_sharding(places)
        for key in ("mu", "nu"):
            assert opt[key] == places
        assert shd.placement_spec(mesh, opt["step"], 0) == \
            _norm(jopt["step"].spec, 0) == ()
        for name, s in dict(_flat(jopt["mu"])).items():
            nd = len(dict(_flat(jparams))[name].shape)
            assert shd.placement_spec(mesh, opt["mu"][name], nd) == \
                _norm(s.spec, nd)


def test_mesh_helpers():
    with M.fake_process_group(8):
        local = M.make_local_mesh(model_parallel=2, device_type="cpu")
        assert local.mesh_dim_names == ("data", "model")
        assert tuple(local.mesh.shape) == (4, 2)
        assert tuple(M.make_local_mesh(device_type="cpu").mesh.shape) == \
            (8, 1)
        sized = M.make_mesh_from_sizes({"pod": 2, "data": 2, "model": 2},
                                       device_type="cpu")
        assert sized.mesh_dim_names == ("pod", "data", "model")
        with pytest.raises(RuntimeError, match="already initialised"):
            with M.fake_process_group(2):
                pass
    import torch.distributed as dist
    assert not dist.is_initialized()
    with M.file_process_group("gloo"):
        assert dist.get_world_size() == 1
        mesh = M.make_local_mesh(device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)
    assert not dist.is_initialized()


def test_placements_refuse_axes_out_of_mesh_order():
    with M.fake_process_group(8):
        mesh = M.make_mesh_from_sizes({"pod": 2, "data": 2, "model": 2},
                                      device_type="cpu")
        with pytest.raises(ValueError, match="mesh's order"):
            shd.placements(mesh, (("data", "pod"),))
        with pytest.raises(ValueError, match="shards two"):
            shd.placements(mesh, ("model", "model"))


# the specs whose index maps are compared on 2×2×2: a tuple of axes on one
# dimension, axes on two, a cache's, a replicated one, a 1-d one
INDEX_CASES = [((8, 4), (("pod", "data"), "model")),
               ((4, 8, 12), ("model", None, ("pod", "data"))),
               ((2, 4, 8, 2, 4), (None, None, ("pod", "data"), None, None)),
               ((6, 4), (None, None)), ((16,), (("pod", "data", "model"),)),
               ((4, 6, 8), ("pod", None, "data"))]

INDEX_REF = """
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(open(sys.argv[1] + "/cases.json").read())
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = []
for shape, spec in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    by_coord = {}
    for c in [(a, b, c) for a in range(2) for b in range(2) for c in range(2)]:
        d = mesh.devices[c]
        by_coord[str(list(c))] = [[s.start or 0, s.stop if s.stop is not None
                                   else n] for s, n in zip(idx[d], shape)]
    out.append(by_coord)
open(sys.argv[1] + "/ref.json", "w").write(json.dumps(out))
"""


def test_every_rank_holds_the_reference_devices_slice(tmp_path):
    (tmp_path / "cases.json").write_text(json.dumps(
        [[list(s), [list(e) if isinstance(e, tuple) else e for e in spec]]
         for s, spec in INDEX_CASES]))
    run_reference(INDEX_REF, 8, tmp_path)
    ref = json.loads((tmp_path / "ref.json").read_text())
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    for rank in range(8):
        coord = list(np.unravel_index(rank, (2, 2, 2)))
        with M.fake_process_group(8, rank=rank):
            mesh = M.make_mesh_from_sizes(
                {"pod": 2, "data": 2, "model": 2}, device_type="cpu")
            assert list(mesh.get_coordinate()) == coord
            for (shape, spec), want in zip(INDEX_CASES, ref):
                local, offset = compute_local_shape_and_global_offset(
                    shape, mesh, list(shd.placements(mesh, spec)))
                got = [[o, o + n] for o, n in zip(offset, local)]
                assert got == want[str([int(c) for c in coord])], \
                    (rank, shape, spec)


# ------------------------------------------------------------------ #
# real DTensors on a gloo group of 4 ranks, (2, 2) data × model: each
# family's loss and every parameter's gradient against the same model on
# plain tensors
# ------------------------------------------------------------------ #
from _torch_procs import run_ranks  # noqa: E402

SHARDED_STEPS = """
import copy, sys, numpy as np, torch
from repro_torch.configs import get_arch
from repro_torch.dist import on_mesh, sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import file_process_group, make_mesh_from_sizes
rank, n, init, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.manual_seed(0)
worst = {}
with file_process_group("gloo", n, rank, init):
    mesh = make_mesh_from_sizes({"data": 2, "model": 2}, device_type="cpu")
    for arch in ("internlm2-1.8b", "qwen3-moe-235b-a22b", "dlrm-rm2",
                 "two-tower-retrieval", "nequip"):
        spec = get_arch(arch)
        cfg = spec.smoke_config
        g = torch.Generator().manual_seed(1)
        plain = spec.init_fn(cfg, g, "cpu")
        plain.requires_grad_(True)
        batch = {k: torch.as_tensor(v) for k, v in
                 spec.smoke_batch(cfg, "train", 0).items()
                 if not np.isscalar(v)}
        loss = spec.loss_fn(plain, cfg, batch)
        loss.backward()
        model = copy.deepcopy(plain)
        model.zero_grad(set_to_none=True)
        if spec.family == "lm":
            places = shd.lm_param_sharding(mesh, model)
            pref = shd.data_axes(mesh)
        elif spec.family == "gnn":
            places = shd.gnn_param_sharding(mesh, model)
            pref = mesh.mesh_dim_names
        else:
            places = shd.recsys_param_sharding(mesh, model)
            pref = shd.data_axes(mesh)
        shd.distribute_module(model, mesh, places)
        from torch.distributed.tensor import distribute_tensor
        db = {k: distribute_tensor(v, mesh, dryrun.first_dim_sharding(mesh, v, pref))
              for k, v in batch.items()}
        with on_mesh.replicated_implicitly():
            dloss = spec.loss_fn(model, cfg, db)
            dloss.backward()
        got = dloss.full_tensor() if on_mesh.is_dtensor(dloss) else dloss
        err = abs(float(got) - float(loss)) / max(abs(float(loss)), 1e-6)
        worst[arch + ":loss"] = err
        assert err < 1e-5, (arch, float(got), float(loss))
        named = dict(model.named_parameters())
        for name, p in plain.named_parameters():
            want = p.grad if p.grad is not None else torch.zeros_like(p)
            dg = named[name].grad
            gotg = torch.zeros_like(want) if dg is None else dg.full_tensor()
            scale = float(want.abs().max()) + 1e-12
            e = float((gotg - want).abs().max()) / scale
            worst[arch + ":" + name] = e
            assert e < 1e-4, (arch, name, e)
np.save(f"{work}/worst{rank}.npy", max(worst.values()))
"""


def test_sharded_steps_match_plain_on_gloo(tmp_path):
    """The smoke configs of an LM (vocab-cut embedding and head, the loss
    over a cut vocabulary), an MoE LM (the dispatch whole on every rank),
    DLRM and two-tower (row-cut tables through ``embedding_bag``'s local
    lookups) and NequIP (node and edge arrays cut over both axes): the
    loss within 1e-5 and every gradient within 1e-4 of its largest
    element, of the same model on plain tensors (the sums run in
    another order)."""
    run_ranks(SHARDED_STEPS, 4, tmp_path, timeout=400)
    assert all(float(np.load(tmp_path / f"worst{r}.npy")) < 1e-4
               for r in range(4))
