"""Index and routing checkpoints for the sharded annotative index.

Layout (one directory per manager):

  index_00000020.log             annotative-index snapshot in the normal
                                 transaction-log format (Segment.to_record
                                 frames + commit markers), so recovery is
                                 just DynamicIndex.recover()
  routing_00000020.routing.json  a ShardedWarren's routing record, with a
                                 crc so a torn write reads as corrupt

Writes land in a tmp name and are published with an atomic rename, so a
reader never sees a partial checkpoint.

This is the framework-free half of the reference's checkpoint manager.  Its
train-state half (``save``/``restore``/``restore_latest_good`` of a pytree
of arrays, ``step_*`` directories with a crc'd manifest) comes with the
training port; ``all_steps``/``latest_step`` already list those
directories, so the two halves share one directory layout.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import List, Optional

from repro_torch import obs

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.

_STEP_RE = re.compile(r"^step_(\d{8})$")
_INDEX_RE = re.compile(r"^(.+)_(\d{8})\.log$")


class CheckpointCorrupt(RuntimeError):
    """On-disk damage: torn write, bad crc, unreadable payload."""


# ------------------------------------------------------------------ #
class CheckpointManager:
    """Versioned index and routing snapshots in one directory; torn
    writes a crash left behind are removed when the manager opens it.
    (The train-state half adds its retention and asynchronous writes.)"""

    def __init__(self, directory: str):
        self.directory = directory
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
