"""One-card dry run: the real step of every (arch × shape) cell, on fake
tensors of one device (``src/repro/launch/dryrun.py`` on a mesh of one).

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
numbers.  ``collectives`` is empty: one device.  The production mesh
(``--multi-pod``, ``--fsdp``) and the HLO collective parser belong to the
multi-card slice; the reference's ``--unroll`` has no counterpart (no
``scan``).

:func:`run_cell` also runs a cell for real (``seed``): the model drawn
from the seed, inputs drawn in range from it, a decode cache at
``length`` S − 1 (every position read), the peak from the allocator's
``max_memory_allocated`` above what was allocated before the cell was
built, and the same FLOP counter, so a real step can be held to its
estimate.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--out FILE] [--device cpu|cuda]

The default device is the card; records are appended to
``experiments/dryrun_torch_<device>x1.jsonl``.
"""

import argparse
import contextlib
import json
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

GRANULE = 512      # the CUDA caching allocator's block granule (bytes)


def _rounded(nbytes: int) -> int:
    return -(-nbytes // GRANULE) * GRANULE


def _tensors(tree) -> list:
    """The tensors in ``tree`` (tuples, lists, dicts; a module's
    parameters and buffers)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
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
    tensor inputs and outputs.  Works on fake and real tensors alike."""

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


def build_cell(arch_name: str, shape_name: str, device, cfg=None,
               seed: int = None):
    """(step, args, meta): the cell's real step and its arguments on
    ``device`` — uninitialised (for fakes) or, with ``seed``, the model
    drawn from the seed and inputs from it.  ``cfg`` (default: the arch's
    full config) sets the model; the cell's shapes are the arch's."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import cfg_for_cell
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import init_opt_state, make_train_step

    spec = get_arch(arch_name)
    cfg = cfg or spec.config
    cell = spec.cells(cfg)[shape_name]
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


def run_cell(arch_name: str, shape_name: str, device="cuda", cfg=None,
             seed: int = None) -> Dict[str, Any]:
    """The cell's record: on fakes of ``device`` (the dry run), or for
    real with ``seed`` (see the module's docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    dev = torch.device(device)
    rec: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                           "mesh": f"{dev.type}x1", "n_devices": 1,
                           "fake": seed is None}
    try:
        if seed is None:
            from torch._subclasses.fake_tensor import FakeTensorMode
            mode = FakeTensorMode()
        else:
            mode = contextlib.nullcontext()
        counter = FlopCounterMode(display=False)
        live = LiveBytes(dev)
        allocator = seed is not None and dev.type == "cuda"
        with mode, live:
            if allocator:
                torch.cuda.synchronize(dev)
                before = torch.cuda.memory_allocated(dev)
            step, args, meta = build_cell(arch_name, shape_name, dev, cfg,
                                          seed)
            rec.update(meta)
            arg_st = storages_bytes(args, dev.type)
            # the step's peak: building's temporaries (a real init's
            # draws) are gone, the arguments stay
            arguments, live.peak, live.accessed = live.live, live.live, 0
            if allocator:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.time()
            with counter:
                out = step(*args)
            if allocator:
                torch.cuda.synchronize(dev)
            rec["trace_s"] = round(time.time() - t1, 3)
            outputs = sum(n for st, n in storages_bytes(out, dev.type).items()
                          if st not in arg_st)
            peak = live.peak
            accessed = live.accessed
            del out, step, args
        rec["memory"] = {"argument_bytes": float(arguments),
                         "output_bytes": float(outputs),
                         "temp_bytes": float(max(peak - arguments
                                                 - outputs, 0)),
                         "peak_bytes": float(peak)}
        if allocator:
            rec["memory"]["allocator_peak_bytes"] = float(
                torch.cuda.max_memory_allocated(dev) - before)
        rec["cost"] = {"flops": float(counter.get_total_flops()),
                       "bytes accessed": float(accessed)}
        rec["collectives"] = {}
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

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: the fakes' device")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh_name = f"{dev.type}x1"
    out_path = args.out or f"experiments/dryrun_torch_{mesh_name}.jsonl"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    cells = []
    for name, spec in ARCHS.items():
        if args.arch and name != args.arch:
            continue
        for shape_name in spec.cells(spec.config):
            if args.shape and shape_name != args.shape:
                continue
            cells.append((name, shape_name))

    n_ok = 0
    with open(out_path, "a") as fh:
        for arch_name, shape_name in cells:
            rec = run_cell(arch_name, shape_name, dev)
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
    print(f"\n{n_ok}/{len(cells)} cells traced on {mesh_name}", flush=True)
    return 0 if n_ok == len(cells) else 1


if __name__ == "__main__":
    sys.exit(main())
