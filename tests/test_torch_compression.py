"""The port's gradient compression (``repro_torch.dist.compression``)
against ``repro.dist.compression``: int8 codes, scales and residuals bit
for bit (``jnp.round`` and ``torch.round`` both round half to even).

At a subnormal scale the two differ by design: XLA on the CPU flushes
subnormal inputs and results to zero, PyTorch keeps IEEE arithmetic
(ROADMAP §3, fault (l)).  The test shows both sides of that: the port
with the CPU's flush-to-zero turned on (``torch.set_flush_denormal``)
gives the reference's bits, and without it keeps the subnormal scale.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import compression as JC  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402

SUBNORMAL = [0.0, 0.0, 0.0, 1.1754943508222875e-38]   # fault (l)'s example


def _same(t: "torch.Tensor", j) -> bool:
    a = np.asarray(j)
    return t.numpy().dtype == a.dtype and t.numpy().tobytes() == a.tobytes()


def _trees(rng, scale):
    shapes = {"w": (16, 8), "b": (8,), "t": (3, 5, 7)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _port(grads, res):
    return TC.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in res.items()})


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4])
def test_compress_bit_for_bit_with_feedback_carry(scale):
    """Five rounds of error feedback: q, scale and residual equal the
    reference's bit for bit each round, and so does the decompression."""
    rng = np.random.default_rng(int(scale * 7) % 1000)
    res = {k: np.zeros_like(v) for k, v in _trees(rng, scale).items()}
    tres = {k: torch.from_numpy(v) for k, v in res.items()}
    jres = {k: jnp.asarray(v) for k, v in res.items()}
    for _ in range(5):
        g = _trees(rng, scale)
        jq, js, jres = JC.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        tq, ts, tres = TC.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres)
        for k in g:
            assert tq[k].dtype == torch.int8
            assert _same(tq[k], jq[k]) and _same(ts[k], js[k])
            assert _same(tres[k], jres[k])
        jd = JC.decompress(jq, js)
        td = TC.decompress(tq, ts)
        assert all(_same(td[k], jd[k]) for k in g)


def test_half_to_even_ties():
    """Values that land exactly on .5 after the division round to even on
    both sides."""
    g = {"x": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5],
                       np.float32)}
    r = {"x": np.zeros(7, np.float32)}
    jq, js, jr = JC.compress_with_feedback(
        {"x": jnp.asarray(g["x"])}, {"x": jnp.asarray(r["x"])})
    tq, ts, tr = _port(g, r)
    assert _same(tq["x"], jq["x"]) and _same(tr["x"], jr["x"])
    assert tq["x"].tolist()[1:6] == [0, 2, 2, 0, -2]


def test_subnormal_scale_flush_to_zero_is_the_only_difference():
    g = {"x": np.array(SUBNORMAL, np.float32)}
    r = {"x": np.zeros(4, np.float32)}
    jq, js, jr = JC.compress_with_feedback(
        {"x": jnp.asarray(g["x"])}, {"x": jnp.asarray(r["x"])})
    # the reference: its subnormal scale is flushed to 0
    assert float(js["x"]) == 0.0
    tq, ts, tr = _port(g, r)
    # the port: IEEE, the scale FLT_MIN / 127 is kept, the residual carries
    # x - q·scale
    assert _same(tq["x"], jq["x"])
    assert ts["x"].item() == pytest.approx(np.finfo(np.float32).tiny / 127)
    assert tr["x"][3].item() != float(np.asarray(jr["x"])[3])
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    try:
        fq, fs, fr = _port(g, r)
    finally:
        torch.set_flush_denormal(False)
    assert _same(fq["x"], jq["x"]) and _same(fs["x"], js["x"])
    assert _same(fr["x"], jr["x"])


def test_init_residual_and_ratio():
    tree = {"a": np.zeros((4, 5), np.float32), "b": np.zeros(3, np.float32)}
    jr = JC.init_residual({k: jnp.asarray(v) for k, v in tree.items()})
    tr = TC.init_residual({k: torch.from_numpy(v) for k, v in tree.items()})
    assert all(_same(tr[k], jr[k]) for k in tree)
    assert TC.compression_ratio({k: torch.from_numpy(v)
                                 for k, v in tree.items()}) == \
        JC.compression_ratio({k: jnp.asarray(v) for k, v in tree.items()})


def test_compressed_train_step_matches_uncompressed_direction():
    """``make_train_step(compress_grads=True)`` carries the residual in the
    optimizer state and moves the parameters as the decompressed gradient
    says (one step, float32, a linear loss)."""
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             make_train_step)
    model = torch.nn.Linear(4, 1, bias=False)
    w0 = model.weight.detach().clone()
    state = init_opt_state(model, compress_grads=True)
    step = make_train_step(lambda m, b: m(b).sum(),
                           AdamWConfig(warmup_steps=0, weight_decay=0.0),
                           compress_grads=True)
    x = torch.tensor([[1.0, -2.0, 0.5, 3.0]])
    state, metrics = step(model, state, x)
    assert set(state) == {"mu", "nu", "step", "ef"}
    moved = torch.sign(w0 - model.weight.detach())
    assert torch.equal(moved, torch.sign(x))
    assert float(metrics["loss"]) == pytest.approx(float((w0 * x).sum()))


# ------------------------------------------------------------------ #
# cross_pod_reduce_compressed over a real gloo group of n ranks, against
# the reference's shard_map on n forced host devices
# ------------------------------------------------------------------ #
from _torch_procs import run_ranks, run_reference  # noqa: E402

CROSS_POD_PORT = """
import sys, numpy as np, torch
import torch.distributed as dist
from repro_torch.launch.mesh import file_process_group, make_mesh_from_sizes
from repro_torch.dist.compression import cross_pod_reduce_compressed
rank, n, init, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
data = np.load(f"{work}/in.npz")
names = sorted({k.split(":")[1] for k in data.files})
with file_process_group("gloo", n, rank, init):
    mesh = make_mesh_from_sizes({"pod": n}, device_type="cpu")
    g = {k: torch.from_numpy(data[f"g:{k}"][rank]) for k in names}
    r = {k: torch.from_numpy(data[f"r:{k}"][rank]) for k in names}
    out, res = cross_pod_reduce_compressed(g, r, mesh, axis_name="pod")
    # every rank done before any tears its group down, and no mesh left
    # holding a group for the interpreter's exit to destroy
    dist.barrier()
    del mesh
np.savez(f"{work}/port{rank}.npz", **{f"out:{k}": out[k].numpy() for k in names},
         **{f"res:{k}": res[k].numpy() for k in names})
"""

CROSS_POD_REF = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.dist.compression import cross_pod_reduce_compressed
work = sys.argv[1]
data = np.load(f"{work}/in.npz")
names = sorted({k.split(":")[1] for k in data.files})
n = data[f"g:{names[0]}"].shape[0]
mesh = jax.make_mesh((n,), ("pod",))
def fn(g, r):
    g = {k: v[0] for k, v in g.items()}
    r = {k: v[0] for k, v in r.items()}
    out, res = cross_pod_reduce_compressed(g, r, axis_name="pod")
    return ({k: v[None] for k, v in out.items()},
            {k: v[None] for k, v in res.items()})
spec = {k: P("pod") for k in names}
out, res = shard_map(fn, mesh=mesh, in_specs=(spec, spec),
                     out_specs=(spec, spec))(
    {k: jnp.asarray(data[f"g:{k}"]) for k in names},
    {k: jnp.asarray(data[f"r:{k}"]) for k in names})
np.savez(f"{work}/ref.npz", **{f"out:{k}": np.asarray(out[k]) for k in names},
         **{f"res:{k}": np.asarray(res[k]) for k in names})
"""


@pytest.mark.parametrize("n", [2, 4])
def test_cross_pod_reduce_bit_for_bit_with_reference(n, tmp_path):
    """Different gradients and residuals on every rank, leaves of odd and
    even sizes (the int32 words' padding lane), a leaf whose values tie at
    half a step; every rank's mean and residual equal the reference's
    device at the same pod index, bit for bit."""
    rng = np.random.default_rng(n)
    shapes = {"w": (16, 8), "b": (7,), "t": (3, 5, 3)}
    arrays = {}
    for k, shape in shapes.items():
        arrays[f"g:{k}"] = (rng.standard_normal((n,) + shape)
                            * 10.0 ** rng.integers(-3, 3, size=(n,) + (1,)
                                                   * len(shape))
                            ).astype(np.float32)
        arrays[f"r:{k}"] = (rng.standard_normal((n,) + shape) * 1e-3
                            ).astype(np.float32)
    arrays["g:b"][:, :3] = [0.5, -1.5, 127.0]
    np.savez(tmp_path / "in.npz", **arrays)
    run_reference(CROSS_POD_REF, n, tmp_path)
    run_ranks(CROSS_POD_PORT, n, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    for rank in range(n):
        got = np.load(tmp_path / f"port{rank}.npz")
        for key in ref.files:
            want = ref[key][rank]
            assert got[key].dtype == want.dtype
            assert got[key].tobytes() == want.tobytes(), (rank, key)


def test_cross_pod_payload_is_two_bytes_a_value(tmp_path):
    """The all-reduce of the values moves int32 words of two lanes: ceil(
    values / 2) · 4 bytes, beside one float32 maximum a leaf."""
    from repro_torch.launch.mesh import fake_process_group, \
        make_mesh_from_sizes
    import torch.distributed as dist
    sizes = []
    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        sizes.append((t.dtype, t.numel() * t.element_size()))
        return real(t, *args, **kwargs)
    g = {"w": torch.ones(16, 8), "b": torch.ones(7)}
    r = TC.init_residual(g)
    with fake_process_group(2):
        mesh = make_mesh_from_sizes({"pod": 2}, device_type="cpu")
        dist.all_reduce = counted
        try:
            TC.cross_pod_reduce_compressed(g, r, mesh)
        finally:
            dist.all_reduce = real
    assert sizes == [(torch.float32, 2 * 4),
                     (torch.int32, -(-(128 + 7) // 2) * 4)]


def test_cross_pod_refuses_more_than_129_ranks():
    from repro_torch.launch.mesh import fake_process_group, \
        make_mesh_from_sizes
    g = {"w": torch.ones(4)}
    with fake_process_group(130):
        mesh = make_mesh_from_sizes({"pod": 130}, device_type="cpu")
        with pytest.raises(ValueError, match="at most 129"):
            TC.cross_pod_reduce_compressed(g, TC.init_residual(g), mesh)
    with fake_process_group(129):
        mesh = make_mesh_from_sizes({"pod": 129}, device_type="cpu")
        out, res = TC.cross_pod_reduce_compressed(g, TC.init_residual(g),
                                                  mesh)
        assert out["w"].shape == (4,)


TRAIN_PORT = """
import sys, numpy as np, torch
import torch.distributed as dist
from repro_torch.launch.mesh import file_process_group, make_mesh_from_sizes
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, make_train_step
rank, n, init, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
data = np.load(f"{work}/in.npz")
model = torch.nn.Module()
model.w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))
def loss_fn(m, b):
    return ((b @ m.w) ** 2).mean()
cfg = AdamWConfig(warmup_steps=0, total_steps=10)
with file_process_group("gloo", n, rank, init):
    mesh = make_mesh_from_sizes({"pod": n}, device_type="cpu")
    step = make_train_step(loss_fn, cfg, compress_grads=True,
                           reduce_axis="pod", mesh=mesh)
    state = init_opt_state(model, compress_grads=True)
    state, metrics = step(model, state, torch.from_numpy(data["x"][rank]))
    dist.barrier()          # as CROSS_POD_PORT: no rank tears down early
    del mesh, step
np.savez(f"{work}/port{rank}.npz", w=model.w.detach().numpy(),
         ef=state["ef"]["w"].numpy(), mu=state["mu"]["w"].numpy(),
         loss=metrics["loss"].numpy())
"""

TRAIN_REF = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.train.optimizer import AdamWConfig, init_opt_state, make_train_step
work = sys.argv[1]
data = np.load(f"{work}/in.npz")
n = data["x"].shape[0]
mesh = jax.make_mesh((n,), ("pod",))
def loss_fn(p, b):
    return ((b @ p["w"]) ** 2).mean()
cfg = AdamWConfig(warmup_steps=0, total_steps=10)
step = make_train_step(loss_fn, cfg, compress_grads=True, reduce_axis="pod")
params = {"w": jnp.asarray(data["w"])}
state = init_opt_state(params, compress_grads=True)
def fn(p, s, x):
    p, s, m = step(p, s, x[0])
    return p, s, m["loss"][None]
rep = jax.tree.map(lambda _: P(), params)
srep = jax.tree.map(lambda _: P(), state)
p, s, loss = shard_map(fn, mesh=mesh, in_specs=(rep, srep, P("pod")),
                       out_specs=(rep, srep, P("pod")), check_rep=False)(
    params, state, jnp.asarray(data["x"]))
np.savez(f"{work}/ref.npz", w=np.asarray(p["w"]), ef=np.asarray(s["ef"]["w"]),
         mu=np.asarray(s["mu"]["w"]), loss=np.asarray(loss))
"""


def test_train_step_reduce_axis_matches_reference(tmp_path):
    """One ``make_train_step(compress_grads=True, reduce_axis="pod")`` step
    on 2 ranks with different batches: the reduced gradient's moment and
    rank 0's residual bit for bit; the parameters within 2 ulps (fault
    (p): XLA's float32 ``cos``/``pow`` in the schedule) and each rank's
    loss within 2 ulps (each framework sums the batch in its own order)."""
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "in.npz",
             w=rng.standard_normal((6, 3)).astype(np.float32),
             x=rng.standard_normal((2, 5, 6)).astype(np.float32))
    run_reference(TRAIN_REF, 2, tmp_path)
    run_ranks(TRAIN_PORT, 2, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    for rank in range(2):
        got = np.load(tmp_path / f"port{rank}.npz")
        assert got["mu"].tobytes() == ref["mu"].tobytes()
        np.testing.assert_array_max_ulp(got["loss"], ref["loss"][rank],
                                        maxulp=2)
        np.testing.assert_array_max_ulp(got["w"], ref["w"], maxulp=2)
    # the reference's out_specs P() keeps pod 0's residual; each port rank
    # keeps its own, and rank 0's is the same bits
    assert np.load(tmp_path / "port0.npz")["ef"].tobytes() == \
        ref["ef"].tobytes()
