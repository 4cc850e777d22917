"""The train-state half of the port's checkpoints
(``repro_torch.dist.checkpoint``) against ``repro.dist.checkpoint``: the
same leaf format, so each package restores the other's checkpoints (a
transformer's per-layer tensors as the reference's stacked leaves,
bfloat16 as raw bytes), a corrupt newest checkpoint falls back to the
one before, a changed structure raises, and ``keep`` collects old steps.
"""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import lm_family as JF  # noqa: E402
from repro.configs import recsys_family as JRF  # noqa: E402
from repro.dist import checkpoint as JCK  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.configs import lm_family as TF  # noqa: E402
from repro_torch.configs import recsys_family as TRF  # noqa: E402
from repro_torch.convert import (model_tree, recsys_from_jax,  # noqa: E402
                                 transformer_from_jax)
from repro_torch.dist import checkpoint as TCK  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402


def _lm(dtype):
    import dataclasses
    jcfg = dataclasses.replace(JF.LM_SPECS["internlm2-1.8b"].smoke_config,
                               dtype=dtype)
    tcfg = dataclasses.replace(TF.get_config("internlm2-1.8b", smoke=True),
                               dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = transformer_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")
    return params, model


def _dlrm():
    spec = JRF.RECSYS_SPECS["dlrm-rm2"]
    params = spec.init_fn(spec.smoke_config, jax.random.PRNGKey(0))
    model = recsys_from_jax(jax.tree.map(np.asarray, params),
                            TRF.get_config("dlrm-rm2", smoke=True), "cpu")
    return params, model


MODELS = {"lm_f32": lambda: _lm("float32"), "lm_bf16": lambda: _lm("bfloat16"),
          "dlrm": _dlrm}


def _port_state(model, step=3, data=None):
    """The trainer's state tree: parameters, optimizer moments (given
    distinct values), the step and the data cursor."""
    opt = TO.init_opt_state(model)
    for i, (k, v) in enumerate(opt["mu"].items()):
        v.fill_(0.25 * i)
        opt["nu"][k].fill_(0.5 + i)
    opt["step"].fill_(step)
    return {"params": model_tree(model),
            "opt": {"mu": model_tree(model, opt["mu"]),
                    "nu": model_tree(model, opt["nu"]), "step": opt["step"]},
            "step": step, "data": data or {"cursor": 5, "epoch": 1}}


def _ref_state(params, step=3, data=None):
    opt = JO.init_opt_state(params)
    return {"params": params, "opt": opt, "step": step,
            "data": data or {"cursor": 5, "epoch": 1}}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_leaves(tree):
    out = []
    for leaf in TCK.tree_leaves(tree):
        if isinstance(leaf, TCK.Stacked):
            out.append(np.stack([_as_np(t) for t in leaf]))
        elif isinstance(leaf, torch.Tensor):
            out.append(_as_np(leaf))
        else:
            out.append(leaf)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_port_writes_what_the_reference_restores(tmp_path, name):
    params, model = MODELS[name]()
    state = _port_state(model)
    TCK.CheckpointManager(str(tmp_path)).save(3, state, block=True)
    like = _ref_state(params, step=0, data={"cursor": 0, "epoch": 0})
    step, got = JCK.CheckpointManager(str(tmp_path)).restore_latest_good(
        like)
    assert step == 3
    ref_leaves = jax.tree.leaves(got)
    port_leaves = _port_leaves(state)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        if isinstance(b, np.ndarray):
            assert _as_np(a).tobytes() == b.tobytes()
            assert np.asarray(a).shape == b.shape
        else:
            assert a == b
    assert got["data"] == {"cursor": 5, "epoch": 1} and got["step"] == 3


@pytest.mark.parametrize("name", list(MODELS))
def test_reference_writes_what_the_port_restores(tmp_path, name):
    params, model = MODELS[name]()
    ref = _ref_state(params, step=7, data={"cursor": 11, "epoch": 2})
    ref["opt"]["mu"] = jax.tree.map(lambda x: x + 0.5, ref["opt"]["mu"])
    ref["opt"]["step"] = jnp.int32(7)
    JCK.CheckpointManager(str(tmp_path)).save(7, ref, block=True)
    like = _port_state(model, step=0, data={"cursor": 0, "epoch": 0})
    step, got = TCK.CheckpointManager(str(tmp_path)).restore_latest_good(
        like)
    assert step == 7 and got["step"] == 7
    assert got["data"] == {"cursor": 11, "epoch": 2}
    for a, b in zip(jax.tree.leaves(ref), _port_leaves(got)):
        if isinstance(b, np.ndarray):
            assert _as_np(a).tobytes() == b.tobytes()
        else:
            assert a == b
    assert got["opt"]["step"].dtype == torch.int32


def test_bf16_leaf_carries_raw_bytes(tmp_path):
    t = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    rec = TCK._pack_leaf(t)
    assert rec["d"] == "bfloat16" and rec["s"] == [3]
    assert rec["b"] == t.view(torch.int16).numpy().tobytes()
    back = TCK._unpack_leaf(rec, t, 0)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_leaf_order_is_jax_tree_leaves_order():
    tree = {"z": [1, {"b": 2, "a": 3}], "a": {"y": 4, "x": (5, 6)}}
    assert TCK.tree_leaves(tree) == jax.tree.leaves(tree)
    assert TCK.tree_unflatten(tree, TCK.tree_leaves(tree)) == tree


def test_corrupt_newest_falls_back_to_the_previous(tmp_path):
    _, model = _lm("float32")
    ck = TCK.CheckpointManager(str(tmp_path))
    for step in (2, 4):
        ck.save(step, _port_state(model, step=step), block=True)
    path = tmp_path / "step_00000004" / "state.msgpack"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(TCK.CheckpointCorrupt):
        ck.restore(4, _port_state(model, step=0))
    step, got = ck.restore_latest_good(_port_state(model, step=0))
    assert step == 2 and got["step"] == 2
    # a torn write (no manifest) is not listed at all
    os.remove(tmp_path / "step_00000002" / "MANIFEST")
    assert ck.all_steps() == [4]


def test_shape_mismatch_raises_and_is_not_skipped(tmp_path):
    _, model = _lm("float32")
    ck = TCK.CheckpointManager(str(tmp_path))
    ck.save(1, _port_state(model, step=1), block=True)
    _, dlrm = _dlrm()
    with pytest.raises(TCK.CheckpointShapeMismatch):
        ck.restore_latest_good(_port_state(dlrm, step=0))
    like = _port_state(model, step=0)
    like["params"]["embed"] = torch.zeros(3, 3)
    with pytest.raises(TCK.CheckpointShapeMismatch, match="leaf"):
        ck.restore(1, like)
    like = _port_state(model, step=0)
    like["params"]["lm_head"] = like["params"]["lm_head"].double()
    with pytest.raises(TCK.CheckpointShapeMismatch):
        ck.restore(1, like)


def test_keep_collects_old_steps_and_manifest(tmp_path):
    ck = TCK.CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 6):
        ck.save(step, {"w": torch.full((2,), float(step)), "step": step})
    ck.wait()
    assert ck.all_steps() == [4, 5]
    man = json.loads((tmp_path / "step_00000005" / "MANIFEST").read_text())
    assert man["step"] == 5 and man["nbytes"] > 0
    got = ck.restore(5, {"w": torch.zeros(2), "step": 0})
    assert got["step"] == 5 and got["w"].tolist() == [5.0, 5.0]
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_async_write_failure_surfaces_in_wait(tmp_path):
    ck = TCK.CheckpointManager(str(tmp_path / "d"))
    os.rmdir(tmp_path / "d")
    (tmp_path / "d").write_text("not a directory")
    ck.save(1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
