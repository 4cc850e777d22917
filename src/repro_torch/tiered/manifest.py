"""Versioned manifest for the tiered storage engine.

One JSON file per version (``MANIFEST-<v>.json``), written tmp + fsync +
atomic rename — the same pattern as ``dist/checkpoint.py``.  A manifest
records the live immutable runs (with their sequence and address-stripe
coverage), the highest seqnum folded out of the hot tier, and the address /
sequence allocation floors, plus a crc over its own payload so a torn write
is detected at load time.

Recovery (:meth:`ManifestStore.load_latest_good`) walks versions newest
first and returns the first manifest that (a) parses, (b) passes its crc,
and (c) whose run directories are all intact on disk — so a crash *between
a run write and the manifest swap* simply falls back to the previous
version, and the orphaned run directory is garbage-collected on the next
open (:meth:`ManifestStore.gc`).  Readers pin a manifest version by holding
the run tuple it described; published manifests are immutable.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, List, Optional

from repro_torch.core.faults import fault_point

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.

_MANIFEST_RE = re.compile(r"^MANIFEST-(\d{8})\.json$")


@dataclass(frozen=True)
class RunInfo:
    """One immutable on-disk run, as recorded by the manifest.

    ``level`` and ``nbytes`` power the leveled compaction policy; they
    default so manifests written before PR 10 still load (all runs at L0,
    sizes re-measured lazily)."""
    run_id: int
    name: str            # directory name under <root>/runs/
    seq_lo: int
    seq_hi: int
    addr_lo: int
    addr_hi: int
    n_records: int
    n_features: int
    level: int = 0       # 0 = freshly frozen; deeper = older, bigger
    nbytes: int = 0      # on-disk size at write time (0: unknown/legacy)

    @staticmethod
    def from_meta(run_id: int, name: str, meta: dict,
                  level: int = 0) -> "RunInfo":
        """From a ``write_run``/``merge_runs``/``slice_run`` meta record."""
        return RunInfo(run_id=run_id, name=name,
                       seq_lo=int(meta["seq_lo"]), seq_hi=int(meta["seq_hi"]),
                       addr_lo=int(meta["addr_lo"]),
                       addr_hi=int(meta["addr_hi"]),
                       n_records=int(meta["n_records"]),
                       n_features=int(meta["n_features"]),
                       level=int(level),
                       nbytes=int(meta.get("nbytes", 0)))


@dataclass(frozen=True)
class Manifest:
    version: int
    frozen_upto: int     # max seqnum folded into runs (-1: nothing frozen)
    next_run_id: int
    next_addr: int       # address-allocation floor at publish time
    next_seq: int        # seqnum-allocation floor at publish time
    runs: List[RunInfo] = field(default_factory=list)
    extra: Dict = field(default_factory=dict)

    @staticmethod
    def initial() -> "Manifest":
        return Manifest(version=0, frozen_upto=-1, next_run_id=0,
                        next_addr=0, next_seq=0)

    def successor(self, **changes) -> "Manifest":
        return replace(self, version=self.version + 1, **changes)

    # -- (de)serialization ------------------------------------------------ #
    def to_json(self) -> str:
        body = asdict(self)
        payload = json.dumps(body, sort_keys=True)
        return json.dumps({"crc": zlib.crc32(payload.encode()),
                           "manifest": body}, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Manifest":
        obj = json.loads(text)
        body = obj["manifest"]
        payload = json.dumps(body, sort_keys=True)
        if zlib.crc32(payload.encode()) != obj.get("crc"):
            raise ValueError("manifest crc mismatch (torn write)")
        runs = [RunInfo(**r) for r in body.pop("runs")]
        return Manifest(runs=runs, **body)


class ManifestCorrupt(RuntimeError):
    """No manifest version on disk is intact."""


class ManifestStore:
    """Publishes and recovers manifest versions under one root directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.runs_dir = os.path.join(directory, "runs")
        self.keep = keep
        os.makedirs(self.runs_dir, exist_ok=True)
        for name in os.listdir(directory):       # torn tmp files from a crash
            if ".tmp-" in name:
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass

    def run_path(self, name: str) -> str:
        return os.path.join(self.runs_dir, name)

    def _versions(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _MANIFEST_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _run_intact(self, info: RunInfo) -> bool:
        path = self.run_path(info.name)
        # v2 block runs carry one file; legacy v1 runs key off meta.msgpack
        return (os.path.exists(os.path.join(path, "run.aix2"))
                or os.path.exists(os.path.join(path, "meta.msgpack")))

    # -- recovery --------------------------------------------------------- #
    def _load_latest_good_impl(self) -> Optional[Manifest]:
        """Newest manifest that parses, passes crc, and names only intact
        run directories; None when no manifest exists at all."""
        versions = self._versions()
        for v in reversed(versions):
            path = os.path.join(self.directory, f"MANIFEST-{v:08d}.json")
            try:
                with open(path) as fh:
                    m = Manifest.from_json(fh.read())
            except (OSError, ValueError, KeyError, TypeError):
                continue
            if all(self._run_intact(r) for r in m.runs):
                return m
        if versions:
            raise ManifestCorrupt(
                f"{len(versions)} manifest versions in {self.directory}, "
                "none intact")
        return None

    load_latest_good = _load_latest_good_impl   # see the note on ``_impl`` names

    # -- publish ---------------------------------------------------------- #
    def _publish_impl(self, manifest: Manifest) -> None:
        """Durably write one manifest version (tmp + fsync + atomic rename),
        then drop versions older than the retention window."""
        final = os.path.join(self.directory,
                             f"MANIFEST-{manifest.version:08d}.json")
        tmp = f"{final}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(manifest.to_json())
            fh.flush()
            os.fsync(fh.fileno())
        fault_point("manifest.written")
        os.replace(tmp, final)
        fault_point("manifest.published")
        for v in self._versions()[:-self.keep]:
            try:
                os.unlink(os.path.join(self.directory,
                                       f"MANIFEST-{v:08d}.json"))
            except OSError:
                pass

    publish = _publish_impl   # see the note on ``_impl`` names

    # -- garbage collection ----------------------------------------------- #
    def gc(self, live: Manifest) -> List[str]:
        """Remove run directories not referenced by ``live`` (orphans from a
        crash between run write and manifest swap, or victims of a finished
        compaction).  Readers pinning an older manifest keep serving: a
        run's mmap and file handles stay valid after unlink (POSIX
        semantics), so lazily decoded blocks remain readable."""
        referenced = {r.name for r in live.runs}
        removed = []
        for name in sorted(os.listdir(self.runs_dir)):
            if name in referenced:
                continue
            path = os.path.join(self.runs_dir, name)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(name)
        return removed
