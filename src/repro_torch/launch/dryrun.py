"""Dry run: the real step of every (arch × shape) cell on fake tensors, on
one device or on the production mesh (``src/repro/launch/dryrun.py``).

For each cell this builds the cell's model and inputs under a
``FakeTensorMode`` on the device (no memory, no data), runs the cell's
real step on them — the train step with its AdamW update
(``train.optimizer.make_train_step``), ``prefill``, ``decode_step``
against the cell's KV cache, or the recsys and GNN families' serve and
loss functions — and records:

  * memory — the bytes of every storage made, live until it is freed
    (:class:`LiveBytes`), on the CUDA allocator's 512-byte granule:
    ``argument_bytes`` (model, optimizer state, inputs, cache),
    ``output_bytes`` (what the step returns that it did not take),
    ``temp_bytes`` (the rest of the peak) and ``peak_bytes``;
  * cost — ``flops`` from ``FlopCounterMode`` (the port's kernels count
    by their own formulas, one operator each) and ``bytes accessed``, the
    bytes of every non-view operator's tensor inputs and outputs;
  * ``fits``: the peak within the device's memory (the card's, or the
    host's for ``cpu``), recorded, never an error.

The kernels are operators with fake implementations, so the fakes pass
through them; nothing reads data, so the step's shapes decide both
numbers.  On one device ``collectives`` is empty.

On the production mesh (``--production``: (16, 16) ``("data",
"model")``; ``--multi-pod``: (2, 16, 16) with ``"pod"``) the cell runs on
a fake process group of 256 or 512 ranks, seen from rank 0: the model,
optimizer state, batch and cache are DTensors of fakes with the placements
of the reference's ``build_cell`` (:func:`place_cell`: the parameters by
their family's policy in ``dist.sharding``, ``--fsdp auto`` meaning FSDP
for MoE; batches by the first-dimension prefix rule, so every shard is
even; recsys ``cand_ids`` on ``model``; a batch-1 decode's KV cache along
the sequence; the optimizer state as the parameters), and the step runs
under ``implicit_replication`` (a plain tensor that model code makes
counts as replicated).  Then memory and FLOPs are each device's (the
local shards' storages; the local operators' FLOPs), ``collectives``
holds each kind's count and result bytes a device (:class:`Collectives`,
``CommDebugMode``'s count with the bytes added: the counterpart of the
reference's HLO parser), and ``layer_axis_leaves`` the transformer leaves
whose stacked form the reference shards along L (``dist.sharding``).  A
cell that fails records ``ok: false`` and its error.  The reference's
``--unroll`` has no counterpart (no ``scan``).

:func:`run_cell` also runs a cell for real (``seed``): the model drawn
from the seed, inputs drawn in range from it, a decode cache at
``length`` S − 1 (every position read), the peak from the allocator's
``max_memory_allocated`` above what was allocated before the cell was
built, and the same FLOP counter, so a real step can be held to its
estimate.  A real run may call the step again (``calls``: each call's
host seconds, synchronised, in ``call_s``; memory and FLOPs stay the
first call's) and look at each call's output (``inspect``).  Either way
the step runs with ``repro_torch.obs`` off (:func:`obs_off`), so the
model's spans and MoE counters add no tensors of their own and a fake
step and a real one make the same.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--cell A:S ...] [--out FILE] [--device cpu|cuda]
      [--production [--multi-pod] [--fsdp {auto,on,off}]]

The default device is the card; records are appended to
``experiments/dryrun_torch_<mesh>.jsonl`` (``cudax1``, ``cpux1`` on one
device; ``pod16x16``, ``pod2x16x16`` on the production mesh, the device
in each record).  A fake group and a real one cannot share a process: run
the production mesh in a process of its own.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.dist import sharding as shd
from repro_torch.dist.on_mesh import local_part, replicated_implicitly

GRANULE = 512      # the CUDA caching allocator's block granule (bytes)


def _rounded(nbytes: int) -> int:
    return -(-nbytes // GRANULE) * GRANULE


def _tensors(tree) -> list:
    """The tensors in ``tree`` (tuples, lists, dicts; a module's
    parameters and buffers), a DTensor as its local shard."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(local_part(x))
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, torch.nn.Module):
            stack.extend(x.parameters())
            stack.extend(x.buffers())
    return out


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages on ``device``'s type that operators make (or
    take, if made outside one), each counted from the first time it is
    seen until it is freed (a ``weakref.finalize`` of the storage), and
    their peak; and ``accessed``: the bytes of every non-view operator's
    tensor inputs and outputs.  Works on fake and real tensors alike.  An
    operator on DTensors is left to DTensor (``NotImplemented``), so what
    is counted are the local operators it runs on this rank's shards and
    the collectives between them: each device's bytes.  Outer modes (the
    FLOP counter, :class:`Collectives`) see only those too."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self._seen = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def _free(self, n: int) -> None:
        with self._lock:
            self.live -= n

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        with self._lock:
            if st in self._seen:
                return
            n = _rounded(st.nbytes())
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:
            self.track(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if not func.is_view:
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        return out


# the reference's collective kinds, by the functional collective's name
KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


class Collectives(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's result bytes a
    device by kind (``stats``: ``{kind: {"count", "bytes"}}``), as the
    reference's ``collective_stats`` sums result shapes in the HLO."""

    def __init__(self):
        super().__init__()
        self.stats: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = getattr(getattr(func, "_overloadpacket", None), "__name__",
                       "")
        kind = KINDS.get(name.removesuffix("_coalesced").rstrip("_"))
        if kind and out is not NotImplemented:
            st = self.stats.setdefault(kind, {"count": 0, "bytes": 0.0})
            st["count"] += 1
            st["bytes"] += float(sum(t.numel() * t.element_size()
                                     for t in _tensors(out)))
        return out


@contextlib.contextmanager
def obs_off():
    """Metrics and tracing off inside, each as it was after."""
    reg, tr = obs.registry(), obs.tracer()
    was = reg.enabled, tr.enabled
    obs.disable()
    try:
        yield
    finally:
        reg.enabled, tr.enabled = was


@contextlib.contextmanager
def shadow_ops_hidden():
    """DTensor derives an operator's output shape by running it once on
    global-shape fakes (the sharding propagator's tensor-meta step), under
    whatever modes are active: those are no device's work or memory.
    Inside this context that step runs with every mode off (on fakes of
    its own), so :class:`LiveBytes`, the FLOP counter and
    :class:`Collectives` see each rank's local operators only."""
    from torch.distributed.tensor._sharding_prop import \
        ShardingPropagator as SP
    from torch.utils._python_dispatch import _disable_current_modes
    saved = {name: SP.__dict__[name] for name in (
        "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
        if name in SP.__dict__}
    if not saved:
        raise RuntimeError("this torch's DTensor has no tensor-meta step "
                           "to hide: the dry run cannot count per device")

    def hidden(fn):
        def run(self, op_schema):
            with _disable_current_modes():
                return fn(self, op_schema)
        return run

    for name, fn in saved.items():
        setattr(SP, name, hidden(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(SP, name, fn)


def exact_bytes(tree) -> int:
    """Bytes of a cell's arguments as the reference counts them: every
    parameter (not the RoPE buffers), optimizer, batch and cache tensor,
    a DTensor's local shard, unrounded."""
    out = 0
    for x in (tree if isinstance(tree, (list, tuple)) else [tree]):
        if isinstance(x, torch.nn.Module):
            x = list(x.parameters())
        out += sum(t.numel() * t.element_size() for t in _tensors(x))
    return out


def storages_bytes(tree, device_type: str) -> Dict[Any, int]:
    """{storage: rounded bytes} of the tensors in ``tree`` on
    ``device_type``."""
    out = {}
    for t in _tensors(tree):
        if t.device.type == device_type:
            st = t.untyped_storage()
            out[st] = _rounded(st.nbytes())
    return out


def device_memory(device: torch.device) -> int:
    """The memory a cell must fit: the card's, or the host's for ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


# --------------------------------------------------------------------- #
def _int_bound(spec, cfg, key: str, specs: Dict[str, torch.Tensor]) -> int:
    """The exclusive upper bound of an int input ``key`` of ``spec``'s
    cells at ``cfg``: ids in range for the lookup they feed."""
    if spec.family == "lm":
        return cfg.vocab
    if spec.family == "gnn":
        return {"species": cfg.n_species, "labels": max(cfg.n_classes, 1),
                "graph_ids": specs["energies"].shape[0]
                if "energies" in specs else 1,
                }.get(key, specs["positions"].shape[0])
    if key == "sparse":
        return cfg.vocab_per_table
    if key == "user_ids":
        return cfg.n_users
    return cfg.n_items


def cell_inputs(spec, cfg, specs: Dict[str, torch.Tensor], device,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
    """Tensors of ``specs``' shapes and dtypes on ``device``: uninitialised
    (fakes, under a ``FakeTensorMode``), or drawn from ``generator`` —
    ids uniform in range, GNN label masks 1, recsys labels 0 or 1, other
    floats N(0, 1)."""
    out = {}
    for key, s in specs.items():
        if generator is None:
            out[key] = torch.empty(s.shape, dtype=s.dtype, device=device)
        elif not s.dtype.is_floating_point:
            out[key] = torch.randint(0, _int_bound(spec, cfg, key, specs),
                                     s.shape, generator=generator,
                                     device=device, dtype=s.dtype)
        elif key == "label_mask":
            out[key] = torch.ones(s.shape, dtype=s.dtype, device=device)
        elif key == "labels":
            out[key] = torch.randint(0, 2, s.shape, generator=generator,
                                     device=device).to(s.dtype)
        else:
            out[key] = torch.randn(s.shape, generator=generator,
                                   device=device, dtype=s.dtype)
    return out


def batch_specs(batch) -> Dict[str, torch.Tensor]:
    """A batch's arrays (numpy or tensors) as meta tensors of their shapes
    and dtypes, the cell's ``batch_specs`` of a run at this batch's
    shapes; scalars (a graph count) are left out."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.empty(v.shape, dtype=v.dtype, device="meta")
        elif hasattr(v, "shape") and getattr(v, "ndim", 0):
            out[k] = torch.empty(v.shape, device="meta",
                                 dtype=torch.from_numpy(v[:0]).dtype)
    return out


def build_cell(arch_name: str, shape_name: str, device, cfg=None,
               seed: int = None, specs: Dict[str, torch.Tensor] = None):
    """(step, args, meta): the cell's real step and its arguments on
    ``device`` — uninitialised (for fakes) or, with ``seed``, the model
    drawn from the seed and inputs from it.  ``cfg`` (default: the arch's
    full config) sets the model; the cell's shapes are the arch's, or
    ``specs`` (:func:`batch_specs`: a cut batch, a sampled graph)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import cfg_for_cell
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import init_opt_state, make_train_step

    spec = get_arch(arch_name)
    cfg = cfg or spec.config
    cell = spec.cells(cfg)[shape_name]
    if specs is not None:
        cell = dataclasses.replace(cell, batch_specs=dict(specs))
    dev = torch.device(device)
    gen = None
    if seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    if spec.family == "gnn":
        cfg = cfg_for_cell(cfg, shape_name)

    meta = {"kind": cell.kind, "note": cell.note}
    m = spec.build_fn(cfg, dev) if gen is None else \
        spec.init_fn(cfg, gen, dev)
    if cell.kind == "train":
        m.requires_grad_(True)
        opt = init_opt_state(m)
        batch = cell_inputs(spec, cfg, cell.batch_specs, dev, gen)
        step = make_train_step(lambda mm, b: spec.loss_fn(mm, cfg, b))
        return step, (m, opt, batch), meta
    if spec.family == "lm" and cell.note == "prefill":
        batch = cell_inputs(spec, cfg, cell.batch_specs, dev, gen)
        return T.prefill, (m, batch["tokens"]), meta
    if spec.family == "lm":
        b = cell.batch_specs["tokens"].shape[0]
        seq = int(cell.note.split("=")[1])
        cache = cell_inputs(spec, cfg, spec.cache_spec(cfg, b, seq), dev)
        if gen is not None:           # every position of the cache read
            for key in ("k", "v"):
                cache[key].normal_(generator=gen)
            cache["length"].fill_(seq - 1)
        batch = cell_inputs(spec, cfg, cell.batch_specs, dev, gen)
        meta["cache_bytes"] = sum(storages_bytes(cache, dev.type).values())
        return T.decode_step, (m, cache, batch["tokens"]), meta
    batch = cell_inputs(spec, cfg, cell.batch_specs, dev, gen)

    @torch.no_grad()
    def serve(mm, b):
        return spec.serve_fn(mm, cfg, b)
    return serve, (m, batch), meta


def first_dim_sharding(mesh, leaf, preferred) -> tuple:
    """The reference's ``_first_dim_sharding``: dim 0 over the longest
    prefix of the axes ``preferred`` whose size it divides."""
    if leaf.dim() == 0:
        return shd.placements(mesh, ())
    return shd.placements(mesh, (shd.prefix_entry(mesh, leaf.shape[0],
                                                  preferred),))


def place_cell(arch_name: str, shape_name: str, args, mesh,
               fsdp_mode: str = "auto"):
    """(args, meta): a cell's arguments from :func:`build_cell` as
    DTensors on ``mesh`` with the placements of the reference's
    ``build_cell``; the model's parameters are replaced in place."""
    from torch.distributed.tensor import distribute_tensor
    spec = __import__("repro_torch.configs", fromlist=["get_arch"]
                      ).get_arch(arch_name)
    model = args[0]
    dp = shd.data_axes(mesh)
    meta: Dict[str, Any] = {}
    if spec.family == "lm":
        fsdp = (model.cfg.moe is not None if fsdp_mode == "auto"
                else fsdp_mode == "on")
        p_sh = shd.lm_param_sharding(mesh, model, fsdp=fsdp)
        meta["fsdp"] = fsdp
        meta["layer_axis_leaves"] = {
            leaf: {k: (v if k == "extra_bytes" else
                       [list(e) if isinstance(e, tuple) else e for e in v])
                   for k, v in info.items()}
            for leaf, info in shd.layer_axis_leaves(mesh, model,
                                                    fsdp).items()}
    elif spec.family == "gnn":
        p_sh = shd.gnn_param_sharding(mesh, model)
    else:
        p_sh = shd.recsys_param_sharding(mesh, model)
    shd.distribute_module(model, mesh, p_sh)

    def batch(tree, preferred):
        return {k: distribute_tensor(
            v, mesh, shd.placements(mesh, ("model",)) if k == "cand_ids"
            else first_dim_sharding(mesh, v, preferred))
            for k, v in tree.items()}

    rest = list(args[1:])
    if len(rest) == 2 and isinstance(rest[0], dict) and "mu" in rest[0]:
        o_sh = shd.opt_state_sharding(p_sh)
        opt = rest[0]
        rest[0] = {"mu": shd.distribute(opt["mu"], mesh, o_sh["mu"]),
                   "nu": shd.distribute(opt["nu"], mesh, o_sh["nu"]),
                   "step": distribute_tensor(opt["step"], mesh,
                                             o_sh["step"])}
        pref = tuple(mesh.mesh_dim_names) if spec.family == "gnn" else dp
        rest[1] = batch(rest[1], pref)
    elif len(rest) == 2:                      # decode: cache, tokens
        cache, tokens = rest
        b = tokens.shape[0]
        long_ctx = b == 1
        c_sh = shd.lm_cache_sharding(mesh, b, long_context=long_ctx)
        rest[0] = shd.distribute(cache, mesh, c_sh)
        rest[1] = distribute_tensor(
            tokens, mesh, shd.placements(mesh, ()) if long_ctx
            else first_dim_sharding(mesh, tokens, dp))
    elif isinstance(rest[0], dict):           # recsys and GNN serving
        pref = tuple(mesh.mesh_dim_names) if spec.family == "gnn" else dp
        rest[0] = batch(rest[0], pref)
    else:                                     # prefill tokens
        rest[0] = distribute_tensor(rest[0], mesh,
                                    first_dim_sharding(mesh, rest[0], dp))
    return (model, *rest), meta


def mesh_name(mesh) -> str:
    """``pod16x16``, ``pod2x16x16``: the reference's names."""
    return "pod" + "x".join(str(n) for n in mesh.mesh.shape)


def run_cell(arch_name: str, shape_name: str, device="cuda", cfg=None,
             seed: int = None, mesh=None, fsdp_mode: str = "auto",
             specs: Dict[str, torch.Tensor] = None, calls: int = 1,
             inspect=None) -> Dict[str, Any]:
    """The cell's record: on fakes of ``device`` (the dry run), or for
    real with ``seed`` (see the module's docstring); on ``mesh`` (a
    ``DeviceMesh`` over a fake group, on fakes only) each device's;
    ``specs`` in place of the cell's batch shapes (:func:`build_cell`).
    A real run calls the step ``calls`` times, and ``inspect(args, out)``
    after each call, its results in ``inspected``; only the first call is
    counted."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    dev = torch.device(device)
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name,
        "mesh": mesh_name(mesh) if mesh is not None else f"{dev.type}x1",
        "n_devices": mesh.size() if mesh is not None else 1,
        "device": dev.type, "fake": seed is None}
    try:
        if seed is None:
            from torch._subclasses.fake_tensor import FakeTensorMode
            mode = FakeTensorMode()
        elif mesh is not None:
            raise ValueError("a cell runs on a mesh on fakes only")
        else:
            mode = contextlib.nullcontext()
        counter = FlopCounterMode(display=False)
        live = LiveBytes(dev)
        comms = Collectives() if mesh is not None else \
            contextlib.nullcontext()
        on_mesh = contextlib.ExitStack()
        if mesh is not None:
            on_mesh.enter_context(replicated_implicitly())
            on_mesh.enter_context(shadow_ops_hidden())
        allocator = seed is not None and dev.type == "cuda"
        with obs_off(), mode:
            with live:
                if allocator:
                    torch.cuda.synchronize(dev)
                    before = torch.cuda.memory_allocated(dev)
                step, args, meta = build_cell(arch_name, shape_name, dev,
                                              cfg, seed, specs)
                rec.update(meta)
                if mesh is not None:
                    args, meta = place_cell(arch_name, shape_name, args,
                                            mesh, fsdp_mode)
                    rec.update(meta)
                    rec["argument_exact_bytes"] = float(exact_bytes(args))
                    if "cache_bytes" in rec:
                        rec["cache_bytes"] = sum(storages_bytes(
                            args[1], dev.type).values())
                gc.collect()     # the global fakes that placing replaced
                arg_st = storages_bytes(args, dev.type)
                # the step's peak: building's temporaries (a real init's
                # draws) are gone, the arguments stay
                arguments, live.peak, live.accessed = live.live, live.live, 0
                if allocator:
                    torch.cuda.synchronize(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.time()
            # the counters outside LiveBytes: on a mesh they see only the
            # local operators, which LiveBytes passes on
            with on_mesh, counter, comms, live:
                out = step(*args)
            if allocator:
                torch.cuda.synchronize(dev)
                allocator_peak = torch.cuda.max_memory_allocated(dev) - before
            first_s = time.time() - t1
            rec["trace_s"] = round(first_s, 3)
            outputs = sum(n for st, n in storages_bytes(out, dev.type).items()
                          if st not in arg_st)
            peak = live.peak
            accessed = live.accessed
            if seed is not None:
                rec["call_s"] = [first_s]
                rec["inspected"] = [inspect(args, out)] if inspect else []
                for _ in range(calls - 1):
                    del out
                    t1 = time.perf_counter()
                    out = step(*args)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    rec["call_s"].append(time.perf_counter() - t1)
                    if inspect:
                        rec["inspected"].append(inspect(args, out))
            del out, step, args
        rec["memory"] = {"argument_bytes": float(arguments),
                         "output_bytes": float(outputs),
                         "temp_bytes": float(max(peak - arguments
                                                 - outputs, 0)),
                         "peak_bytes": float(peak)}
        if allocator:
            rec["memory"]["allocator_peak_bytes"] = float(allocator_peak)
        rec["cost"] = {"flops": float(counter.get_total_flops()),
                       "bytes accessed": float(accessed)}
        rec["collectives"] = comms.stats if mesh is not None else {}
        capacity = device_memory(dev)
        rec["capacity_bytes"] = float(capacity)
        rec["fits"] = bool(peak <= capacity)
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 3)
    return rec


def main(argv=None):
    from repro_torch.configs import ARCHS
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as M

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--cell", action="append", default=[],
                    help="ARCH:SHAPE, repeatable: these cells only")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the fakes' device")
    ap.add_argument("--production", action="store_true",
                    help="the production mesh (16, 16) on a fake group of "
                         "256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) production mesh, 512 ranks")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    production = args.production or args.multi_pod
    name = ("pod2x16x16" if args.multi_pod else "pod16x16") if production \
        else f"{dev.type}x1"
    out_path = args.out or f"experiments/dryrun_torch_{name}.jsonl"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    wanted = [tuple(c.split(":", 1)) for c in args.cell]
    cells = []
    for arch, spec in ARCHS.items():
        if args.arch and arch != args.arch:
            continue
        for shape_name in spec.cells(spec.config):
            if args.shape and shape_name != args.shape:
                continue
            if wanted and (arch, shape_name) not in wanted:
                continue
            cells.append((arch, shape_name))

    group = M.fake_process_group(512 if args.multi_pod else 256) \
        if production else contextlib.nullcontext()
    n_ok = 0
    with group, open(out_path, "a") as fh:
        mesh = M.make_production_mesh(multi_pod=args.multi_pod,
                                      device_type=dev.type) \
            if production else None
        for arch_name, shape_name in cells:
            rec = run_cell(arch_name, shape_name, dev, mesh=mesh,
                           fsdp_mode=args.fsdp)
            line = {k: v for k, v in rec.items() if k != "traceback"}
            fh.write(json.dumps(line) + "\n")
            fh.flush()
            status = "OK " if rec["ok"] else "FAIL"
            mem = rec.get("memory", {}).get("peak_bytes", 0) / 2**30
            fl = rec.get("cost", {}).get("flops", 0)
            fits = "fits" if rec.get("fits") else "does not fit"
            print(f"[{status}] {arch_name:24s} {shape_name:16s} "
                  f"peak={mem:9.2f}GiB flops={fl:.3e} {fits} "
                  f"({rec['total_s']}s)", flush=True)
            if not rec["ok"]:
                print(rec["error"], flush=True)
            else:
                n_ok += 1
    print(f"\n{n_ok}/{len(cells)} cells traced on {name}", flush=True)
    return 0 if n_ok == len(cells) else 1


if __name__ == "__main__":
    sys.exit(main())
