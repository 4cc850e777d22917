"""Live shard rebalancing: stream segments between replica groups without
pausing writers.

``Rebalancer`` reshapes a running :class:`~repro_torch.dist.shard_router.
ShardedWarren` — splitting one replica group into two, or merging two into
one — while writers keep committing and readers keep serving.  Both
operations follow the same three-phase protocol:

  1. **Freeze + bulk stream.**  The source group's committed segments are
     snapshotted at a freeze seqnum (``max_committed_seq``) and streamed to
     the destination in the durable ``Segment.to_record`` form — the same
     stream replica resurrection and cold-demotion recovery use.  A merge
     fence (``set_merge_fence``) pins the source's segment set so a
     concurrent auto-merge cannot collapse segments across the freeze
     watermark mid-stream.  Readers and writers are untouched: the source
     keeps serving and committing.
  2. **Tail catch-up.**  Commits that landed above the freeze seqnum are
     replayed from the source's published segment sequence in bounded
     rounds (each round streams the new tail and advances the watermark),
     until the tail is small.
  3. **Atomic swap.**  Under the source group's write lock — the only
     writer stall, measured and reported as ``RebalanceStats.swap_s`` —
     the final tail is streamed, the group states are rewritten, and a
     successor :class:`~repro_torch.dist.shard_router.RoutingTable` is published
     with a bumped epoch.  Group epochs are bumped *before* the state
     rewrite and the table *after*, so read sessions can never pair a
     pre-swap table with post-swap state (see the shard_router module
     docstring); sessions pinned to the old table keep serving their
     immutable snapshots.  In-flight transactions staged against the old
     topology are re-staged transparently by ``ShardedWarren.commit``.

**Split** partitions the source's committed address range at a *document
boundary* (the median content-record address by default): annotations and
content move with the side owning their start address — the rule cross-
shard routing already uses — and both sides receive an *erased-carrier*
segment holding the group's full tombstone union, because a tombstone may
be recorded in a segment that lands wholly on the other side (erasure is a
point-set over addresses; losing a tombstone would resurrect erased
content).  The destination inherits the upper half of the split range; the
side whose allocation cursor landed in the moved range is granted a fresh
address stripe, so address spaces never collide.

**Merge** streams the absorbed group's segments into the surviving group
with their sequence numbers rebased above the survivor's (preserving the
absorbed group's internal order, so exact-interval tie-breaks are
unchanged; cross-group ties are impossible — address ranges are disjoint).
The absorbed group is *retired*: still addressable (health, checkpoint,
resurrect), but it owns no ranges, takes no appends, and serves empty.

**Demoted groups** rebalance by shipping *runs* instead of records.  A
cold merge copies the absorbed group's immutable run directories
file-level into the survivor's run set and publishes a successor manifest
(:func:`repro_torch.tiered.merge_demoted`); a cold split ships **sliced run
sets** (:func:`repro_torch.tiered.split_demoted`): runs wholly on one side of
the pivot are copied file-level, straddlers are cut by footer-index
extents (postings masked by start address, content moved as raw
compressed payloads), and both sides carry the full tombstone union — in
neither direction is the group promoted or a record decoded.

Failure model: fail-stop, same as the router.  If the source group loses
its last live replica (or is demoted/retired under the migration), the
operation raises :class:`RebalanceAborted` — the routing table is never
published partially, the destination group is discarded, and a retry after
``resurrect`` starts clean.  Nothing the rebalancer does is visible to
readers or writers until the single atomic table publish.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.annotation import union_intervals
from repro_torch.core.index import (DynamicIndex, Segment, erased_carrier,
                              partition_segment)
from repro_torch.core.log import TransactionLog
from repro_torch.dist.shard_router import (ReplicaFailure, ReplicaGroup,
                                     RoutingTable, ShardedWarren)


class RebalanceError(RuntimeError):
    """The requested rebalance is invalid (unknown/retired group, no
    document boundary to split at, ...)."""


class RebalanceAborted(RebalanceError):
    """The migration could not complete (source group lost all replicas,
    was demoted/retired mid-stream).  The routing table was NOT changed:
    no successor was published, the destination group was discarded, and
    the warren keeps serving exactly as before.  Retry after repair."""


@dataclass
class RebalanceStats:
    """One completed rebalance, as measured."""
    kind: str                       # "split" | "merge" | "merge-demoted"
    source: int
    dest: int
    epoch: int                      # routing epoch published by the swap
    freeze_seq: int = -1
    pivot: Optional[int] = None
    segments_streamed: int = 0
    catchup_rounds: int = 0
    copy_s: float = 0.0             # bulk stream (no locks held)
    catchup_s: float = 0.0          # tail rounds (no locks held)
    swap_s: float = 0.0             # THE writer stall: lock-held window

    def summary(self) -> str:
        return (f"{self.kind} {self.source}->{self.dest} epoch {self.epoch}: "
                f"{self.segments_streamed} segments streamed "
                f"(copy {1e3 * self.copy_s:.1f} ms, "
                f"{self.catchup_rounds} catch-up rounds "
                f"{1e3 * self.catchup_s:.1f} ms), writer stall "
                f"{1e3 * self.swap_s:.2f} ms")


_FENCE_ALL = 1 << 62        # merge fence high enough to pin every segment


class Rebalancer:
    """Online split/merge of a ShardedWarren's replica groups.

    One migration runs at a time per warren family (the shared
    ``rebalance_lock``); serving is never paused.  Bulk streaming fans out
    over the warren's ScatterGather pool when one is available (or the
    ``pool`` argument), so migration work never runs on a serving thread.
    """

    def __init__(self, warren: ShardedWarren, pool=None):
        self.warren = warren
        self.pool = pool if pool is not None else warren.scatter_pool
        self.history: List[RebalanceStats] = []

    @property
    def last_stats(self) -> Optional[RebalanceStats]:
        return self.history[-1] if self.history else None

    def _record(self, stats: RebalanceStats) -> None:
        """Append to history and publish the migration to the registry —
        the swap stall is the one number a rebalance can hurt serving by."""
        self.history.append(stats)
        reg = obs.registry()
        if reg.enabled:
            reg.counter("rebalance_total", "completed migrations",
                        kind=stats.kind).inc()
            reg.histogram("rebalance_swap_stall_ms",
                          "writer stall of the atomic swap window"
                          ).observe(1e3 * stats.swap_s)

    def _record_abort(self, kind: str) -> None:
        """Count an aborted migration — the signal the autopilot's
        backoff policy watches (the routing table was left untouched)."""
        reg = obs.registry()
        if reg.enabled:
            reg.counter("rebalance_aborted_total",
                        "migrations aborted with the table unchanged",
                        kind=kind).inc()

    # ------------------------------------------------------------------ #
    def _hook(self, stage: str, gid: int) -> None:
        hook = self.warren.hooks.get("mid_migration")
        if hook is not None:
            hook(self.warren, stage, gid)

    def _group(self, gid: int) -> ReplicaGroup:
        if not 0 <= gid < len(self.warren.groups):
            raise RebalanceError(f"no shard group {gid}")
        grp = self.warren.groups[gid]
        if grp.retired:
            raise RebalanceError(f"shard group {gid} is retired")
        return grp

    def _serving_index(self, grp: ReplicaGroup) -> DynamicIndex:
        try:
            return grp.replicas[grp.first_alive()]
        except ReplicaFailure as e:
            raise RebalanceAborted(
                f"shard group {grp.group_id} lost every replica "
                "mid-migration; routing table unchanged") from e

    def _stream(self, segments, transform) -> List:
        """Stream segments through the durable record form, applying
        ``transform(Segment) -> Optional[Segment]`` to each copy."""
        def one(seg):
            return transform(Segment.from_record(seg.to_record()))
        if self.pool is not None and len(segments) > 1:
            out = self.pool.map(one, segments)
        else:
            out = [one(s) for s in segments]
        return [s for s in out if s is not None]

    def _bulk_and_catchup(self, grp: ReplicaGroup, transform,
                          out: List[Segment]) -> Tuple[int, int, int, int,
                                                       float, float]:
        """The shared lock-free migration prefix: snapshot the source at a
        freeze seqnum, bulk-stream its committed segments through
        ``transform`` into ``out``, then replay the tail committed above
        the watermark in bounded catch-up rounds.  Returns
        ``(freeze_seq, streamed_watermark, n_streamed, rounds, copy_s,
        catchup_s)``; the final (under-lock) tail is the caller's job."""
        src_idx = self._serving_index(grp)
        with src_idx._publish_lock:
            segs0 = src_idx._segments
        freeze_seq = max((s.seqnum for s in segs0), default=-1)
        t0 = time.perf_counter()
        with obs.span("bulk_copy", group=grp.group_id):
            out.extend(self._stream(segs0, transform))
        streamed, n_streamed = freeze_seq, len(segs0)
        copy_s = time.perf_counter() - t0
        self._hook("after_copy", grp.group_id)
        t0 = time.perf_counter()
        rounds = 0
        with obs.span("catchup", group=grp.group_id):
            for _ in range(8):
                src_idx = self._serving_index(grp)
                with src_idx._publish_lock:
                    segs = src_idx._segments
                tail = [s for s in segs if s.seqnum > streamed]
                if not tail:
                    break
                rounds += 1
                out.extend(self._stream(tail, transform))
                streamed = max(s.seqnum for s in tail)
                n_streamed += len(tail)
                if len(tail) <= 2:
                    break
        catchup_s = time.perf_counter() - t0
        self._hook("before_swap", grp.group_id)
        return freeze_seq, streamed, n_streamed, rounds, copy_s, catchup_s

    # ------------------------------------------------------------------ #
    def split_group(self, source: int,
                    pivot: Optional[int] = None) -> int:
        """Split ``source`` into two groups; returns the new group's id.

        The new group owns the source range's upper half ``[pivot, hi)``
        (``pivot`` defaults to the median committed document boundary) and
        starts with the same replica count.  Writers keep committing
        throughout; the only stall is the routing-table swap.
        """
        w = self.warren
        with w._ctx["rebalance_lock"]:
            grp = self._group(source)
            if grp.demoted is not None:
                # cold split: ship sliced run sets (footer-index
                # subranges) — the group is never promoted or decoded
                table: RoutingTable = w._ctx["table"]
                try:
                    with obs.span("rebalance.split", source=source,
                                  demoted=True):
                        return self._split_demoted_locked(grp, table, pivot)
                except RebalanceAborted:
                    self._record_abort("split-demoted")
                    raise
            table: RoutingTable = w._ctx["table"]
            for idx in grp.replicas:
                idx.set_merge_fence(_FENCE_ALL)
            try:
                with obs.span("rebalance.split", source=source):
                    return self._split_locked(grp, table, pivot)
            except RebalanceAborted:
                self._record_abort("split")
                raise
            finally:
                for idx in grp.replicas:
                    idx.set_merge_fence(-1)

    def _split_demoted_locked(self, grp: ReplicaGroup, table: RoutingTable,
                              pivot: Optional[int]) -> int:
        """Split a *cold* group by shipping sliced run sets
        (:func:`repro_torch.tiered.split_demoted`): runs wholly on one side of
        the pivot are copied file-level, straddlers are cut by
        footer-index extents, and both sides carry the full tombstone
        union — no promotion, no record decoding.  Cold groups take no
        writes (a write would promote, and promotion needs the write lock
        we hold), so holding the lock across the file I/O stalls no one.
        """
        from repro_torch.core.static import StaticIndex
        from repro_torch.tiered import ManifestStore, StaticWarren, split_demoted

        w = self.warren
        source = grp.group_id
        # pivot: the median document (record) boundary, read footer-only
        ms = ManifestStore(grp.demoted)
        sm = ms.load_latest_good()
        if sm is None:
            raise RebalanceAborted(
                f"shard group {source} has no latest-good manifest in "
                f"{grp.demoted!r}; routing table unchanged")
        los: List[int] = []
        for info in sm.runs:
            si = StaticIndex(ms.run_path(info.name), w.tokenizer,
                             w.featurizer)
            los.extend(lo for lo, _ in si.record_bounds())
            si.close()
        los.sort()
        if pivot is None:
            if len(los) < 2:
                raise RebalanceError(
                    f"shard group {source} has {len(los)} documents — "
                    "nothing to split")
            pivot = los[len(los) // 2]
        rng = table.range_containing(pivot)
        if rng is None or rng[2] != source:
            raise RebalanceError(
                f"pivot {pivot} is not inside a range owned by group "
                f"{source}")
        rlo, rhi, _ = rng
        if pivot <= rlo:
            raise RebalanceError(f"pivot {pivot} at/below range base {rlo}")

        new_gid = len(w.groups)
        tok, feat = w.tokenizer, w.featurizer
        fresh = table.fresh_stripe()
        cursor = sm.next_addr
        moved_alloc = pivot <= cursor < rhi
        keep_dir = f"{grp.demoted}.e{grp.epoch + 1}.keep"
        moved_dir = f"{grp.demoted}.e{grp.epoch + 1}.moved"

        t0 = time.perf_counter()
        with obs.span("swap", group=source), grp.write_lock:
            if grp.demoted is None or grp.retired:
                raise RebalanceAborted(
                    f"shard group {source} was promoted/retired "
                    "mid-migration; routing table unchanged")
            grp.epoch += 1                    # BEFORE any state rewrite
            try:
                keep_m, moved_m = split_demoted(
                    grp.demoted, keep_dir, moved_dir, pivot, rhi,
                    keep_next_addr=fresh[0] if moved_alloc else cursor,
                    moved_next_addr=cursor if moved_alloc else fresh[0],
                    tokenizer=tok, featurizer=feat)
                keep_static = StaticWarren(keep_dir, tok, feat)
                moved_static = StaticWarren(moved_dir, tok, feat)
            except BaseException:
                # the file I/O failed AFTER the epoch bump: publish a
                # same-topology successor so the epoch handshake re-syncs
                # and the group keeps serving its untouched run set; the
                # partially-built side directories are discarded
                import shutil
                shutil.rmtree(keep_dir, ignore_errors=True)
                shutil.rmtree(moved_dir, ignore_errors=True)
                epochs = list(table.group_epochs)
                epochs[source] = grp.epoch
                w._ctx["table"] = table.successor(group_epochs=epochs)
                raise
            # source keeps the complement side; pinned static clones keep
            # serving the old run set (their mmaps outlive the swap)
            grp.static = keep_static
            grp.demoted = keep_dir
            dest_replicas = [DynamicIndex(tok, feat, log_path=None)
                             for _ in range(grp.n_replicas)]
            dest_grp = ReplicaGroup(new_gid, dest_replicas)
            dest_grp.demoted = moved_dir
            dest_grp.static = moved_static
            w.groups.append(dest_grp)
            ranges = [r for r in table.ranges if r != rng]
            ranges += [(rlo, pivot, source), (pivot, rhi, new_gid),
                       (fresh[0], fresh[1],
                        source if moved_alloc else new_gid)]
            epochs = list(table.group_epochs) + [0]
            epochs[source] = grp.epoch
            w._ctx["table"] = table.successor(   # publish: swap complete
                ranges=ranges,
                write_groups=table.write_groups + (new_gid,),
                group_epochs=epochs)
        swap_s = time.perf_counter() - t0
        self._record(RebalanceStats(
            kind="split-demoted", source=source, dest=new_gid,
            epoch=w._ctx["table"].epoch, pivot=pivot,
            segments_streamed=len(moved_m.runs), swap_s=swap_s))
        return new_gid

    def _split_locked(self, grp: ReplicaGroup, table: RoutingTable,
                      pivot: Optional[int]) -> int:
        w = self.warren
        source = grp.group_id
        src_idx = self._serving_index(grp)
        with src_idx._publish_lock:
            segs0 = src_idx._segments       # pivot selection only; the
            # freeze snapshot itself is taken inside _bulk_and_catchup

        # choose the pivot: a committed document (record) boundary
        los = sorted(r.lo for s in segs0 for r in s.content.records())
        if pivot is None:
            if len(los) < 2:
                raise RebalanceError(
                    f"shard group {source} has {len(los)} documents — "
                    "nothing to split")
            pivot = los[len(los) // 2]
        rng = table.range_containing(pivot)
        if rng is None or rng[2] != source:
            raise RebalanceError(
                f"pivot {pivot} is not inside a range owned by group "
                f"{source}")
        rlo, rhi, _ = rng
        if pivot <= rlo:
            raise RebalanceError(f"pivot {pivot} at/below range base {rlo}")

        new_gid = len(w.groups)
        tok, feat = w.tokenizer, w.featurizer
        dest_replicas = [DynamicIndex(tok, feat, log_path=None)
                         for _ in range(grp.n_replicas)]
        for d in dest_replicas:
            d.auto_merge_threshold = src_idx.auto_merge_threshold
        # log-backed source family: the destination must get durable logs
        # too (in the same directory), else the moved half would survive in
        # NO log once the source compacts its own
        src_log = src_idx._log.path
        dest_log_dir = os.path.dirname(src_log) if src_log else None

        # 1+2. bulk stream + tail catch-up (no locks), partitioning each
        # segment at the pivot: the inside half moves, the outside stays
        move_segs: List[Segment] = []
        keep_segs: List[Segment] = []

        def _partition_into(seg: Segment) -> Optional[Segment]:
            inside, outside = partition_segment(seg, pivot, rhi)
            if outside is not None:
                keep_segs.append(outside)
            return inside

        (freeze_seq, streamed, n_streamed, rounds, copy_s,
         catchup_s) = self._bulk_and_catchup(grp, _partition_into, move_segs)

        # 3. atomic swap: the only writer stall
        t0 = time.perf_counter()
        with obs.span("swap", group=source), grp.write_lock:
            if grp.demoted is not None or grp.retired:
                raise RebalanceAborted(
                    f"shard group {source} was demoted/retired "
                    "mid-migration; routing table unchanged")
            src_idx = self._serving_index(grp)
            with src_idx._publish_lock:
                segs_now = src_idx._segments
            tail = [s for s in segs_now if s.seqnum > streamed]
            if tail:
                move_segs.extend(self._stream(tail, _partition_into))
                n_streamed += len(tail)
            max_seq = max((s.seqnum for s in segs_now), default=-1)
            erased_full = union_intervals([s.erased for s in segs_now])
            with src_idx._addr_lock:
                src_next_addr = src_idx._next_addr
                src_next_seq = src_idx._next_seq
            keep_final = list(keep_segs)
            move_final = list(move_segs)
            if len(erased_full):
                keep_final.append(erased_carrier(max_seq, rlo, erased_full))
                move_final.append(erased_carrier(max_seq, pivot, erased_full))
            keep_final.sort(key=lambda s: s.seqnum)
            move_final.sort(key=lambda s: s.seqnum)
            fresh = table.fresh_stripe()
            moved_alloc = pivot <= src_next_addr < rhi

            grp.epoch += 1                    # BEFORE any state rewrite
            for dst in grp.replicas:
                with dst._publish_lock:
                    dst._segments = tuple(keep_final)
                    dst._version += 1
                    dst._trim_cache()
                if moved_alloc:
                    with dst._addr_lock:
                        dst._next_addr = fresh[0]
            for d in dest_replicas:
                d._segments = tuple(move_final)
                d._version = 1
                d._next_addr = src_next_addr if moved_alloc else fresh[0]
                d._next_seq = src_next_seq
            dest_grp = ReplicaGroup(new_gid, dest_replicas)
            w.groups.append(dest_grp)

            ranges = [r for r in table.ranges if r != rng]
            ranges += [(rlo, pivot, source), (pivot, rhi, new_gid),
                       (fresh[0], fresh[1],
                        source if moved_alloc else new_gid)]
            epochs = list(table.group_epochs) + [0]
            epochs[source] = grp.epoch
            w._ctx["table"] = table.successor(   # publish: swap complete
                ranges=ranges,
                write_groups=table.write_groups + (new_gid,),
                group_epochs=epochs)
        swap_s = time.perf_counter() - t0

        if dest_log_dir is not None:
            # log-backed family: the destination gets its own per-replica
            # logs (same directory), written durably BEFORE the source
            # compacts the moved half out of its logs — a crash in between
            # leaves the moved documents in both log sets (at-least-once;
            # the routing record arbitrates ownership at recovery), never
            # in zero.  Done only after the swap succeeded, so an aborted
            # migration leaves no log files behind.
            for r, d in enumerate(dest_replicas):
                d._log.close()
                d._log = TransactionLog(os.path.join(
                    dest_log_dir, f"shard{new_gid:02d}r{r}.log"))
                d.compact_log()
        for idx in grp.replicas:      # durable logs forget the moved half
            idx.compact_log()
        stats = RebalanceStats(
            kind="split", source=source, dest=new_gid,
            epoch=w._ctx["table"].epoch, freeze_seq=freeze_seq, pivot=pivot,
            segments_streamed=n_streamed, catchup_rounds=rounds,
            copy_s=copy_s, catchup_s=catchup_s, swap_s=swap_s)
        self._record(stats)
        return new_gid

    # ------------------------------------------------------------------ #
    def merge_groups(self, dest: int, source: int) -> None:
        """Fold ``source`` into ``dest``; ``source`` is retired (empty but
        addressable) and its address ranges re-home to ``dest``.  Writers
        keep committing throughout; the only stall is the swap window."""
        w = self.warren
        if dest == source:
            raise RebalanceError("merge of a group with itself")
        with w._ctx["rebalance_lock"]:
            dgrp, sgrp = self._group(dest), self._group(source)
            table: RoutingTable = w._ctx["table"]
            if dgrp.demoted is not None and sgrp.demoted is not None:
                try:
                    with obs.span("rebalance.merge", source=source,
                                  dest=dest, demoted=True):
                        self._merge_demoted_locked(dgrp, sgrp, table)
                except RebalanceAborted:
                    self._record_abort("merge-demoted")
                    raise
                return
            # mixed hot/cold: promote the cold side, then merge hot
            if dgrp.demoted is not None:
                dgrp.promote()
            if sgrp.demoted is not None:
                sgrp.promote()
            for idx in sgrp.replicas:
                idx.set_merge_fence(_FENCE_ALL)
            try:
                with obs.span("rebalance.merge", source=source, dest=dest):
                    self._merge_locked(dgrp, sgrp, table)
            except RebalanceAborted:
                self._record_abort("merge")
                raise
            finally:
                for idx in sgrp.replicas:
                    idx.set_merge_fence(-1)

    def _merge_locked(self, dgrp: ReplicaGroup, sgrp: ReplicaGroup,
                      table: RoutingTable) -> None:
        w = self.warren
        dest, source = dgrp.group_id, sgrp.group_id
        # 1+2. bulk stream + tail catch-up (no locks); the absorbed group's
        # segments travel whole (unsliced), so their erased intervals and
        # internal tie order travel with them
        copies: List[Segment] = []
        (freeze_seq, streamed, n_streamed, rounds, copy_s,
         catchup_s) = self._bulk_and_catchup(sgrp, lambda s: s, copies)

        # 3. atomic swap under BOTH groups' locks (ascending id order —
        #    the same discipline quorum commits use, so no deadlocks)
        t0 = time.perf_counter()
        first, second = sorted([dgrp, sgrp], key=lambda g: g.group_id)
        with obs.span("swap", group=source), \
                first.write_lock, second.write_lock:
            if (dgrp.demoted is not None or sgrp.demoted is not None
                    or dgrp.retired or sgrp.retired):
                raise RebalanceAborted(
                    "a group was demoted/retired mid-merge; "
                    "routing table unchanged")
            dst_idx = self._serving_index(dgrp)
            src_idx = self._serving_index(sgrp)
            with src_idx._publish_lock:
                segs_now = src_idx._segments
            tail = [s for s in segs_now if s.seqnum > streamed]
            if tail:
                copies.extend(self._stream(tail, lambda s: s))
                n_streamed += len(tail)
            # rebase the absorbed sequence numbers above the survivor's,
            # preserving their relative order (tie-breaks intact; cross-
            # group exact ties are impossible — disjoint addresses)
            copies.sort(key=lambda s: s.seqnum)
            with dst_idx._addr_lock:
                seq_base = dst_idx._next_seq
            for i, c in enumerate(copies):
                c.seqnum = seq_base + i
            new_next_seq = seq_base + len(copies)

            dgrp.epoch += 1                   # BEFORE any state rewrite
            sgrp.epoch += 1
            for dst in dgrp.replicas:
                with dst._publish_lock:
                    merged = sorted(list(dst._segments) + copies,
                                    key=lambda s: s.seqnum)
                    dst._segments = tuple(merged)
                    dst._version += 1
                    dst._trim_cache()
                with dst._addr_lock:
                    dst._next_seq = new_next_seq
            for idx in sgrp.replicas:
                with idx._publish_lock:
                    idx._segments = ()
                    idx._version += 1
                    idx._trim_cache()
            sgrp.retired = True

            ranges = tuple((lo, hi, dest if gid == source else gid)
                           for lo, hi, gid in table.ranges)
            epochs = list(table.group_epochs)
            epochs[dest], epochs[source] = dgrp.epoch, sgrp.epoch
            w._ctx["table"] = table.successor(   # publish: swap complete
                ranges=ranges,
                write_groups=tuple(g for g in table.write_groups
                                   if g != source),
                group_epochs=epochs)
        swap_s = time.perf_counter() - t0

        for idx in dgrp.replicas + sgrp.replicas:
            idx.compact_log()
        self._record(RebalanceStats(
            kind="merge", source=source, dest=dest,
            epoch=w._ctx["table"].epoch, freeze_seq=freeze_seq,
            segments_streamed=n_streamed, catchup_rounds=rounds,
            copy_s=copy_s, catchup_s=catchup_s, swap_s=swap_s))

    def _merge_demoted_locked(self, dgrp: ReplicaGroup, sgrp: ReplicaGroup,
                              table: RoutingTable) -> None:
        """Merge two *cold* groups by shipping run manifests — the absorbed
        group's immutable run directories are copied file-level into the
        survivor's run set; no segment records are decoded and neither
        group is promoted.  Cold groups take no writes (a write would
        promote, and promotion needs the write lock we hold), so holding
        both locks across the file copies stalls no one."""
        from repro_torch.tiered import StaticWarren, merge_demoted

        w = self.warren
        dest, source = dgrp.group_id, sgrp.group_id
        t0 = time.perf_counter()
        first, second = sorted([dgrp, sgrp], key=lambda g: g.group_id)
        with obs.span("swap", group=source), \
                first.write_lock, second.write_lock:
            if dgrp.demoted is None or sgrp.demoted is None:
                raise RebalanceAborted(
                    "a group was promoted mid-merge; retry")
            dgrp.epoch += 1                   # BEFORE any state rewrite —
            sgrp.epoch += 1                   # same handshake as hot merge
            try:
                shipped = len(merge_demoted(dgrp.demoted,
                                            sgrp.demoted).runs) \
                    - len(dgrp.static.manifest.runs)
                dgrp.static = StaticWarren(dgrp.demoted, w.tokenizer,
                                           w.featurizer)
            except BaseException:
                # the file I/O failed AFTER the epoch bumps: publish a
                # same-topology successor table so the epoch handshake
                # re-syncs and both groups keep serving; retry is safe
                # (merge_demoted skips runs already shipped)
                epochs = list(table.group_epochs)
                epochs[dest], epochs[source] = dgrp.epoch, sgrp.epoch
                w._ctx["table"] = table.successor(group_epochs=epochs)
                raise
            sgrp.retired = True
            sgrp.demoted = None
            sgrp.static = None
            ranges = tuple((lo, hi, dest if gid == source else gid)
                           for lo, hi, gid in table.ranges)
            epochs = list(table.group_epochs)
            epochs[dest], epochs[source] = dgrp.epoch, sgrp.epoch
            w._ctx["table"] = table.successor(
                ranges=ranges,
                write_groups=tuple(g for g in table.write_groups
                                   if g != source),
                group_epochs=epochs)
        swap_s = time.perf_counter() - t0
        self._record(RebalanceStats(
            kind="merge-demoted", source=source, dest=dest,
            epoch=w._ctx["table"].epoch, segments_streamed=shipped,
            swap_s=swap_s))

    # ------------------------------------------------------------------ #
    def split_group_async(self, source: int,
                          pivot: Optional[int] = None) -> Future:
        """Run ``split_group`` off the caller's thread; returns a Future
        resolving to the new group id.  Always a dedicated thread, never
        the scatter pool: the migration fans its own segment streaming
        onto the pool, so running the outer job there too could occupy
        the last worker and deadlock the stream behind itself."""
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.split_group(source, pivot))
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="rebalance-split").start()
        return fut
