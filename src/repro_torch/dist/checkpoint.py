"""Atomic, versioned checkpointing for train state *and* the dynamic index
(``src/repro/dist/checkpoint.py``).

Layout (one directory per manager):

  step_00000020/state.msgpack    flattened tree leaves (raw array bytes)
  step_00000020/MANIFEST         json: {"step", "crc", "nbytes"}
  index_00000020.log             annotative-index snapshot in the normal
                                 transaction-log format (Segment.to_record
                                 frames + commit markers), so recovery is
                                 just DynamicIndex.recover()
  routing_00000020.routing.json  a ShardedWarren's routing record, with a
                                 crc so a torn write reads as corrupt

Writes land in a tmp name and are published with an atomic rename, so a
reader never sees a partial checkpoint.  Restores verify the manifest crc;
``restore_latest_good`` walks backwards past corrupt/torn checkpoints to
the newest intact one.  ``async_write=True`` copies the state to host
bytes synchronously and does the file I/O on a worker thread.

The train state is the reference's format, leaf for leaf, so each package
restores the other's checkpoints: ``state.msgpack`` is ``{"n", "leaves"}``
(written through :mod:`repro_torch.core.packing`), each leaf ``{"k":
"nd", "d": dtype, "s": shape, "b": raw bytes}`` or ``{"k": "py", "v":
value}``, in ``jax.tree.leaves`` order: dict keys sorted, lists in order,
recursively.  A tree's leaves are tensors (any device), Python numbers,
or :class:`Stacked` lists of equal tensors written as one leaf stacked
on a new first axis (the reference's stacked ``[L, ...]`` layer leaves).
A bfloat16 leaf carries ``d = "bfloat16"`` and its raw bytes, read and
written as bytes, never through numpy.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import packing

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.

_STEP_RE = re.compile(r"^step_(\d{8})$")
_INDEX_RE = re.compile(r"^(.+)_(\d{8})\.log$")
_ROUTING_RE = re.compile(r"^(.+)_(\d{8})\.routing\.json$")


class CheckpointCorrupt(RuntimeError):
    """On-disk damage: torn write, bad crc, unreadable payload."""


class CheckpointShapeMismatch(RuntimeError):
    """Intact checkpoint whose structure doesn't match the restore target
    (e.g. the model or optimizer config changed).  Deliberately NOT skipped
    by restore_latest_good — silently restarting from step 0 is worse."""


# ------------------------------------------------------------------ #
# trees and leaves
# ------------------------------------------------------------------ #
class Stacked(list):
    """Tensors of one shape and dtype, written as one leaf stacked along a
    new first axis, and restored as a list of tensors again."""


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in
    ``jax.tree.leaves`` order (dict keys sorted); ``None`` is no leaf."""
    if isinstance(tree, Stacked):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves: list):
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Stacked):
            return next(it)
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes in C order, through uint8 (so bfloat16 never
    passes through numpy)."""
    flat = t.detach().contiguous().reshape(-1)
    return flat.cpu().view(torch.uint8).numpy().tobytes()


def _pack_leaf(leaf) -> dict:
    if isinstance(leaf, (bool, int, float)):
        return {"k": "py", "v": leaf}
    if isinstance(leaf, np.generic):
        return {"k": "py", "v": leaf.item()}
    if isinstance(leaf, Stacked):
        first = leaf[0]
        return {"k": "nd", "d": _dtype_name(first.dtype),
                "s": [len(leaf)] + list(first.shape),
                "b": b"".join(_raw(t) for t in leaf)}
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return {"k": "nd", "d": _dtype_name(leaf.dtype), "s": list(leaf.shape),
            "b": _raw(leaf)}


def _unpack_leaf(rec: dict, like, where: int):
    if rec["k"] == "py":
        if isinstance(like, (torch.Tensor, Stacked)):
            raise CheckpointShapeMismatch(
                f"leaf {where}: a number where a tensor is expected")
        return rec["v"]
    dtype = getattr(torch, rec["d"], None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointCorrupt(f"leaf {where}: unknown dtype {rec['d']!r}")
    shape = tuple(rec["s"])
    t = torch.frombuffer(bytearray(rec["b"]), dtype=torch.uint8)
    t = t.view(dtype).reshape(shape)
    if isinstance(like, Stacked):
        want = (len(like),) + tuple(like[0].shape)
        if shape != want or dtype != like[0].dtype:
            raise CheckpointShapeMismatch(
                f"leaf {where}: {rec['d']} {list(shape)}, the target "
                f"{like[0].dtype} {list(want)}")
        return Stacked(t.unbind(0))
    if isinstance(like, torch.Tensor) and (
            shape != tuple(like.shape) or dtype != like.dtype):
        raise CheckpointShapeMismatch(
            f"leaf {where}: {rec['d']} {list(shape)}, the target "
            f"{like.dtype} {list(like.shape)}")
    return t


def _serialize(tree) -> bytes:
    leaves = tree_leaves(tree)
    return packing.packb({"n": len(leaves),
                          "leaves": [_pack_leaf(x) for x in leaves]})


def _deserialize(payload: bytes, like):
    try:
        obj = packing.unpackb(payload)
    except packing.PackingError as e:
        raise CheckpointCorrupt(f"unreadable payload: {e}") from e
    flat = tree_leaves(like)
    if obj["n"] != len(flat):
        raise CheckpointShapeMismatch(
            f"checkpoint has {obj['n']} leaves, expected {len(flat)} — "
            "did the model/optimizer config change since it was written?")
    return tree_unflatten(like, [_unpack_leaf(r, x, i) for i, (r, x)
                                 in enumerate(zip(obj["leaves"], flat))])


# ------------------------------------------------------------------ #
class CheckpointManager:
    """Versioned save/restore with retention and latest-good recovery, and
    index and routing snapshots, in one directory; torn writes a crash
    left behind are removed when the manager opens it."""

    def __init__(self, directory: str, keep: Optional[int] = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):    # torn writes from a crash
            if ".tmp-" in name:
                path = os.path.join(directory, name)
                try:
                    (shutil.rmtree if os.path.isdir(path)
                     else os.unlink)(path)
                except OSError:
                    pass
        self._fs_lock = obs.ProfiledLock("checkpoint_fs")
        self._q: Optional["queue.Queue"] = None
        self._write_error: Optional[BaseException] = None
        if async_write:
            self._q = queue.Queue()
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- listing ---------------------------------------------------- #
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "MANIFEST")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------- #
    def _save_impl(self, step: int, tree, block: bool = False) -> None:
        payload = _serialize(tree)      # host copy happens HERE, synchronously
        if self._q is None:
            self._write(step, payload)
            return
        self._q.put((step, payload))
        if block:
            self.wait()

    save = _save_impl   # see the note on ``_impl`` names

    def _wait_impl(self) -> None:
        """Block until all queued async writes are durable.

        Raises if any queued write failed — a caller that asked for a
        durable checkpoint must not be told it has one.
        """
        if self._q is not None:
            self._q.join()
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError("async checkpoint write failed") from err

    wait = _wait_impl   # see the note on ``_impl`` names

    def _drain_impl(self):
        while True:
            step, payload = self._q.get()
            try:
                self._write(step, payload)
            except Exception as e:      # keep the worker alive, keep the error
                self._write_error = e
            finally:
                self._q.task_done()

    _drain = _drain_impl   # see the note on ``_impl`` names

    def _write_impl(self, step: int, payload: bytes) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        with self._fs_lock:
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "state.msgpack"), "wb") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            manifest = {"step": step, "crc": zlib.crc32(payload),
                        "nbytes": len(payload)}
            with open(os.path.join(tmp, "MANIFEST"), "w") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)       # atomic publish
            self._gc()

    _write = _write_impl   # see the note on ``_impl`` names

    def _gc_impl(self) -> None:
        if self.keep is None:
            return
        steps = self.all_steps()
        for step in steps[:-self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{step:08d}"),
                          ignore_errors=True)
            for name in os.listdir(self.directory):
                m = _INDEX_RE.match(name) or _ROUTING_RE.match(name)
                if m and int(m.group(2)) == step:
                    os.unlink(os.path.join(self.directory, name))

    _gc = _gc_impl   # see the note on ``_impl`` names

    # -- restore ------------------------------------------------------ #
    def _restore_impl(self, step: int, like):
        """The tree saved at ``step``, shaped like ``like``: tensors come
        back on the CPU (a :class:`Stacked` leaf as a list of them),
        numbers as numbers.  Raises :class:`CheckpointCorrupt` on damage
        and :class:`CheckpointShapeMismatch` where a leaf's count, shape
        or dtype differs from ``like``'s."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "MANIFEST")) as fh:
                manifest = json.load(fh)
            with open(os.path.join(d, "state.msgpack"), "rb") as fh:
                payload = fh.read()
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorrupt(f"step {step}: {e}") from e
        if zlib.crc32(payload) != manifest.get("crc"):
            raise CheckpointCorrupt(f"step {step}: crc mismatch")
        return _deserialize(payload, like)

    restore = _restore_impl   # see the note on ``_impl`` names

    def restore_latest_good(self, like):
        """Newest intact checkpoint as (step, state); (None, None) if none.

        Corrupt or torn checkpoints are skipped, not fatal — the pod-loss
        recovery path must make progress off whatever survived.
        """
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like)
            except CheckpointCorrupt:
                continue
        return None, None


    # -- the dynamic index ------------------------------------------- #
    def _save_index_impl(self, step: int, index, name: str = "index") -> str:
        """Snapshot a DynamicIndex as a compacted transaction log."""
        from repro_torch.core.log import TransactionLog

        with index._publish_lock:
            segments = index._segments
        records = []
        for seg in segments:
            records.append(seg.to_record())
            records.append({"t": "commit", "seq": seg.seqnum})
        final = os.path.join(self.directory, f"{name}_{step:08d}.log")
        tmp = f"{final}.tmp-{os.getpid()}"
        log = TransactionLog(tmp)
        for rec in records:
            log.append(rec, sync=False)
        log.close()
        with self._fs_lock:
            os.replace(tmp, final)
        return final

    save_index = _save_index_impl   # see the note on ``_impl`` names

    def restore_index(self, step: int, name: str = "index",
                      tokenizer=None, featurizer=None,
                      log_path: Optional[str] = None):
        """Rebuild a DynamicIndex from its snapshot log (or None).

        The restored index logs to ``log_path`` (in-memory when None) —
        never back into the checkpoint file itself.
        """
        from repro_torch.core.index import DynamicIndex
        from repro_torch.core.log import TransactionLog

        path = os.path.join(self.directory, f"{name}_{step:08d}.log")
        if not os.path.exists(path):
            return None
        index = DynamicIndex.recover(path, tokenizer=tokenizer,
                                     featurizer=featurizer)
        index._log.close()
        index._log = TransactionLog(log_path)
        return index

    def restore_index_replicas(self, step: int, name: str = "index",
                               n: int = 1, tokenizer=None, featurizer=None,
                               log_path: Optional[str] = None) -> List:
        """Fan one index snapshot out to ``n`` independent replicas.

        The snapshot log is recovered from disk once; siblings are deep
        copies through the durable segment form (``Segment.to_record`` /
        ``from_record``), so every replica owns its segments and content
        stores — no shared mutable state, and no repeated log replay.
        Raises FileNotFoundError when the snapshot is absent: a replicated
        restore must not silently hand back an empty group.

        ``log_path`` names the transaction log of the FIRST replica only
        and is rejected for n > 1 — replicas sharing one append log would
        interleave duplicate-seqnum frames and double-replay on recovery;
        give each sibling its own log after restore instead.
        """
        from repro_torch.core.index import DynamicIndex, Segment

        if log_path is not None and n > 1:
            raise ValueError(
                "log_path with n > 1 would share one transaction log "
                "across replicas; attach per-replica logs after restore")
        first = self.restore_index(step, name=name, tokenizer=tokenizer,
                                   featurizer=featurizer, log_path=log_path)
        if first is None:
            raise FileNotFoundError(
                f"no index snapshot {name!r} at step {step} "
                f"in {self.directory}")
        replicas = [first]
        for _ in range(max(1, n) - 1):
            idx = DynamicIndex(first.tokenizer, first.featurizer,
                               log_path=None)
            idx._segments = tuple(Segment.from_record(s.to_record())
                                  for s in first._segments)
            idx._version = 1
            idx._next_addr = first._next_addr
            idx._next_seq = first._next_seq
            replicas.append(idx)
        return replicas

    # -- shard routing ------------------------------------------------- #
    def _save_routing_impl(self, step: int, record: dict,
                     name: str = "routing") -> str:
        """Persist a ShardedWarren routing record (routing-table ranges,
        epochs, write groups, per-group allocation floors) next to the
        step's shard snapshots — tmp + fsync + atomic rename, with a crc
        so a torn write reads as absent, not as a wrong topology."""
        body = json.dumps(record, sort_keys=True)
        payload = json.dumps({"crc": zlib.crc32(body.encode()),
                              "routing": record}, sort_keys=True)
        final = os.path.join(self.directory, f"{name}_{step:08d}.routing.json")
        tmp = f"{final}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        with self._fs_lock:
            os.replace(tmp, final)
        return final

    save_routing = _save_routing_impl   # see the note on ``_impl`` names

    def restore_routing(self, step: int,
                        name: str = "routing") -> Optional[dict]:
        """The routing record saved at ``step``; None only when the file
        is absent (a legacy checkpoint, which restores with the striped
        default).  A present-but-torn record raises CheckpointCorrupt —
        silently falling back to striped routing would misroute every
        address a rebalance ever moved."""
        path = os.path.join(self.directory, f"{name}_{step:08d}.routing.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                obj = json.load(fh)
            record = obj["routing"]
            body = json.dumps(record, sort_keys=True)
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise CheckpointCorrupt(
                f"step {step}: unreadable routing record: {e}") from e
        if zlib.crc32(body.encode()) != obj.get("crc"):
            raise CheckpointCorrupt(
                f"step {step}: routing record crc mismatch (torn write)")
        return record

    def index_steps(self, name: str = "index") -> List[int]:
        steps = []
        for fn in os.listdir(self.directory):
            m = _INDEX_RE.match(fn)
            if m and m.group(1) == name:
                steps.append(int(m.group(2)))
        return sorted(steps)
