"""The port's ``ArchSpec`` registry against the reference's
(``repro.configs``): the 40 cells, the LM decode caches, the GNN cells'
configs, every arch's abstract parameters at full width, the smoke
batches, a train step and every serve output through the registry at the
smoke configs (the reference's weights carried across by the
converters), and the five kernel operators under ``torch.library.opcheck``.

Tolerances are each family's own: the port's float32 loss within RATIO
(8) × the reference's float32-vs-float64 distance (floored at one float32
ulp of the loss: the recsys losses end in float32 in the float64 run too)
plus one float32 ulp (``test_torch_train_lm.within_spread``'s rule for
serving; MoE's float64 reference with its
int32 widened, ``test_torch_moe.reference_x64``; NequIP's with a float64
working dtype, ``test_torch_nequip._wide``; two-tower's loss floored at
the reference's own chunked-vs-full 1e-5, fault (b)); recsys serving as
``test_torch_recsys`` holds it (the port's float64 run stands for the
exact result).
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

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro.configs import all_cells as j_all_cells  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs.gnn_family import cfg_for_cell as j_cfg_for_cell  # noqa
from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.configs.gnn_family import cfg_for_cell  # noqa: E402
from repro_torch.convert import (model_tree, nequip_from_jax,  # noqa: E402
                                 recsys_from_jax, transformer_from_jax)
from repro_torch.dist.checkpoint import Stacked  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         init_opt_state, make_train_step)
from test_torch_moe import reference_x64  # noqa: E402
from test_torch_nequip import _wide  # noqa: E402
from test_torch_recsys import _assert_matches_jax  # noqa: E402
from test_torch_train_lm import RATIO, within_spread  # noqa: E402

CELLS = [(a, s) for a, s, _ in all_cells()]
ARCH_NAMES = list(dict.fromkeys(a for a, _ in CELLS))
DECODE = [(a, s) for a, s, c in all_cells() if c.note.startswith("decode")]
GNN_SHAPES = [s for a, s in CELLS if a == "nequip"]
SERVED = [a for a in ARCH_NAMES if get_arch(a).serve_fn is not None]
FAULT_B = 1e-5      # two-tower's chunked-vs-full loss rtol (fault (b))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: torch on one thread in each of the suite's parallel
    workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return np.dtype(x).name


def _spec_of(x):
    return tuple(x.shape), _dtype(x.dtype)


# ------------------------------------------------------------------ #
# cells
# ------------------------------------------------------------------ #
def test_all_cells_are_the_reference_s():
    assert CELLS == [(a, s) for a, s, _ in j_all_cells()]
    assert len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_cell_matches_reference(arch, shape):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    cell = spec.cells(spec.config)[shape]
    want = jspec.cells(jspec.config)[shape]
    assert (cell.shape_name, cell.kind, cell.note) == (
        want.shape_name, want.kind, want.note)
    assert list(cell.batch_specs) == list(want.batch_specs)
    for k, v in cell.batch_specs.items():
        assert v.device.type == "meta"
        assert _spec_of(v) == _spec_of(want.batch_specs[k]), k


@pytest.mark.parametrize("arch,shape", DECODE,
                         ids=[f"{a}/{s}" for a, s in DECODE])
def test_lm_cache_spec_matches_reference(arch, shape):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    cell = spec.cells(spec.config)[shape]
    b = cell.batch_specs["tokens"].shape[0]
    seq = int(cell.note.split("=")[1])
    got = spec.cache_spec(spec.config, b, seq)
    want = jspec.cache_spec(jspec.config, b, seq)
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert _spec_of(got[k]) == _spec_of(want[k]), k


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_gnn_cell_config_matches_reference(shape):
    """Field by field; the reference's ``scan_unroll`` steers its compiler
    and has no counterpart."""
    got = dataclasses.asdict(cfg_for_cell(get_arch("nequip").config, shape))
    want = dataclasses.asdict(j_cfg_for_cell(j_get_arch("nequip").config,
                                             shape))
    assert set(want) - set(got) == {"scan_unroll"}
    assert got == {k: want[k] for k in got}


# ------------------------------------------------------------------ #
# abstract parameters at full width
# ------------------------------------------------------------------ #
def _port_leaves(tree, path=()):
    if isinstance(tree, Stacked):
        return [(path, ((len(tree),) + tuple(tree[0].shape),
                        _dtype(tree[0].dtype)))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _port_leaves(v, path + (i,))]
    return [(path, _spec_of(tree))]


def _ref_leaves(tree):
    out = []
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(e, "key", getattr(e, "idx", None)) for e in p)
        out.append((key, _spec_of(leaf)))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_match_reference(arch):
    """Every leaf at the full config: path, shape (a transformer layer
    leaf stacked as [L, ...]) and dtype, no memory taken."""
    spec, jspec = get_arch(arch), j_get_arch(arch)
    model = spec.abstract_params()
    assert all(p.device.type == "meta" for p in model.parameters())
    got = _port_leaves(model_tree(model))
    want = _ref_leaves(jspec.abstract_params())
    assert sorted(got) == sorted(want)


# ------------------------------------------------------------------ #
# smoke batches
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_batch_is_the_reference_s(arch, kind):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    got = spec.smoke_batch(spec.smoke_config, kind, 3)
    want = jspec.smoke_batch(jspec.smoke_config, kind, 3)
    assert list(got) == list(want)
    for k, v in got.items():
        if np.isscalar(v):
            assert v == want[k], k
            continue
        w = np.asarray(want[k])
        assert v.dtype == w.dtype and v.shape == w.shape, k
        np.testing.assert_array_equal(v, w, err_msg=k)


# ------------------------------------------------------------------ #
# train and serve through the registry (the reference's weights)
# ------------------------------------------------------------------ #
def _port_model(spec, cfg, np_params):
    if spec.family == "lm":
        return transformer_from_jax(np_params, cfg, "cpu")
    if spec.family == "gnn":
        return nequip_from_jax(np_params, cfg, "cpu")
    return recsys_from_jax(np_params, cfg, "cpu")


def _jx(batch, dtype=None):
    return {k: (v if np.isscalar(v) else
                jnp.asarray(v, dtype) if dtype is not None
                and np.asarray(v).dtype.kind == "f" else jnp.asarray(v))
            for k, v in batch.items()}


def _reference_loss64(arch, jspec, jcfg, params, batch) -> float:
    """The reference's loss in float64 (the weights widened)."""
    if arch.startswith("qwen") and "moe" in arch:
        ctx, cfg = reference_x64(), jcfg
    else:
        ctx = jax.enable_x64(True)
        cfg = _wide(jcfg) if jspec.family == "gnn" else jcfg
    with ctx:
        p64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                           params)
        return float(jspec.loss_fn(p64, cfg, _jx(batch, jnp.float64)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_through_the_registry(arch):
    """``spec.loss_fn`` on the smoke batch against the reference's within
    the family's tolerance; then two AdamW steps of
    ``make_train_step``: the first takes that loss, moves the parameters,
    and the second's loss is finite (the reference's
    ``test_train_step_smoke``)."""
    spec, jspec = get_arch(arch), j_get_arch(arch)
    jcfg, cfg = jspec.smoke_config, spec.smoke_config
    params = jspec.init_fn(jcfg, jax.random.PRNGKey(0))
    batch = spec.smoke_batch(cfg, "train", 1)
    ref32 = float(jspec.loss_fn(params, jcfg, _jx(batch)))
    ref64 = _reference_loss64(arch, jspec, jcfg, params, batch)
    model = _port_model(spec, cfg, jax.tree.map(np.asarray, params))
    got = float(spec.loss_fn(model, cfg, batch))
    # the recsys losses end in float32 in the reference's float64 run too
    # (SASRec's logits and mask are cast to float32 before the mean), so
    # the spread can be 0 by a rounding coincidence: it is floored at one
    # float32 ulp of the loss
    ulp = float(np.spacing(np.float32(abs(ref64))))
    tol = RATIO * max(abs(ref32 - ref64), ulp) + ulp
    if arch == "two-tower-retrieval":
        tol = max(tol, FAULT_B * abs(ref32))
    assert abs(got - ref32) <= tol, (got, ref32, ref64)

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.requires_grad_(True)
    opt = init_opt_state(model)
    step = make_train_step(lambda m, b: spec.loss_fn(m, cfg, b),
                           AdamWConfig(warmup_steps=2, total_steps=10))
    opt, m1 = step(model, opt, batch)
    assert float(m1["loss"]) == got
    assert any(not torch.equal(before[n], p.detach())
               for n, p in model.named_parameters())
    _, m2 = step(model, opt, batch)
    assert np.isfinite(float(m2["loss"]))


@pytest.mark.parametrize("arch", SERVED)
def test_serve_through_the_registry(arch):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    jcfg, cfg = jspec.smoke_config, spec.smoke_config
    params = jspec.init_fn(jcfg, jax.random.PRNGKey(0))
    batch = spec.smoke_batch(cfg, "serve", 2)
    model = _port_model(spec, cfg, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = spec.serve_fn(model, cfg, batch)
    want = np.asarray(jspec.serve_fn(params, jcfg, _jx(batch)))
    if spec.family == "recsys":
        with torch.no_grad():
            got64 = spec.serve_fn(copy.deepcopy(model).double(), cfg, batch)
        _assert_matches_jax(got, got64, want)
        return
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                           params)
        want64 = np.asarray(jspec.serve_fn(p64, _wide(jcfg),
                                           _jx(batch, jnp.float64)))
    assert got.shape == want.shape
    within_spread(got.numpy(), want, want64, arch)


def test_serve_fn_is_none_for_the_lms():
    assert [a for a in ARCH_NAMES if get_arch(a).serve_fn is None] == [
        a for a in ARCH_NAMES if j_get_arch(a).serve_fn is None]


# ------------------------------------------------------------------ #
# the kernels as operators
# ------------------------------------------------------------------ #
def _op_cases():
    from repro_torch.kernels.bm25_blockmax import kernel as bm
    from repro_torch.kernels.embedding_bag import kernel as eb
    from repro_torch.kernels.gqa_decode import kernel as gq
    from repro_torch.kernels.interval_join import kernel as ij
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-30, 30, (5, 3), generator=g, dtype=torch.int32)
    w = torch.rand(5, 3, generator=g)
    a_s = torch.tensor([1, 5, 9, 12], dtype=torch.int32)
    b_s = torch.tensor([0, 4, 11], dtype=torch.int32)
    return {
        "gqa_decode": (gq.gqa_decode, (
            torch.randn(2, 2, 3, 16, generator=g),
            torch.randn(2, 40, 2, 16, generator=g),
            torch.randn(2, 40, 2, 16, generator=g),
            torch.tensor([40, 17], dtype=torch.int32))),
        "embedding_bag": (eb.embedding_bag, (
            torch.randn(30, 8, generator=g, requires_grad=True), ids, w)),
        "embedding_bag_backward": (eb.embedding_bag_backward, (
            torch.randn(5, 8, generator=g), ids, w, 30)),
        "interval_join": (ij.interval_join_op, (
            a_s, a_s + 2, b_s, b_s + 3, "contained_in", None)),
        "blockmax_scores": (bm.blockmax_scores, (
            torch.rand(3, 4, 8, generator=g), torch.rand(3, 4, generator=g),
            torch.tensor([1.0]))),
    }


@pytest.mark.parametrize("name", ["gqa_decode", "embedding_bag",
                                  "embedding_bag_backward", "interval_join",
                                  "blockmax_scores"])
def test_kernel_operator_passes_opcheck(name):
    """Schema, autograd registration, the fake implementation against the
    eager one, and AOT dispatch with dynamic shapes, on CPU inputs."""
    op, args = _op_cases()[name]
    assert torch.library.opcheck(op, args) == {
        t: "SUCCESS" for t in ("test_schema", "test_autograd_registration",
                               "test_faketensor",
                               "test_aot_dispatch_dynamic")}
    assert hasattr(torch.ops.repro_torch, name)
