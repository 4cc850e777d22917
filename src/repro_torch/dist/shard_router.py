"""ShardedWarren: hash-partitioned, replicated serving over K shard groups.

Each *logical shard* is a :class:`ReplicaGroup` of R lockstep
:class:`DynamicIndex` replicas.  Which group owns which committed address
is decided by a versioned :class:`RoutingTable`: a sorted set of disjoint
address ranges, each tagged with its owning group.  A fresh warren starts
with the classic striped table (group g owns [g*STRIPE, (g+1)*STRIPE)), and
live rebalancing (:mod:`repro_torch.dist.rebalance`) publishes successor tables —
splitting one group's range at a document boundary, retagging a merged
group's ranges, granting fresh stripes for new allocations — each with a
monotonically increasing *epoch*.

Routing epochs and read consistency: every read session (``start``) pins
ONE table version and one read warren per group, and accepts the pinned set
only if each group's ``epoch`` matches what the table expects — a
rebalance bumps the group epoch *before* rewriting replica state and
publishes the successor table *after*, so a session can never pair a
post-swap group state with a pre-swap table (or vice versa).  Pinned
sessions keep serving their immutable snapshots across a swap; the next
``start`` (or a mid-session failover that trips the epoch check) re-pins
against the current table.  Session reads stay monotonic: the per-group
seqnum high-water mark is keyed by (group, epoch) and the swap only
publishes once the destination holds everything the source committed.

Write path: a ShardedWarren transaction fans out into per-group
transactions, opened lazily; inside a group every live replica stages the
same operations, so deterministic transaction building keeps replicas in
address lockstep.  All *appends* of one transaction land on one group
(chosen by hashing the first appended document over the table's
``write_groups``), which keeps the transaction's staging-address space
consistent; annotations and erases on committed addresses route to their
owners through the *current* table.  Commit is a two-phase *quorum*
commit across the touched groups: phase 1 durably readies the transaction
on every live replica of every group, holding each group's write lock in
ascending group order (no deadlocks, and a replica can never be resurrected
mid-window) — if any group readies fewer than ⌈(R+1)/2⌉ replicas the whole
cross-shard transaction aborts cleanly (:class:`QuorumError`); phase 2
publishes on every readied replica that is still live.  A replica whose
ready/commit raises is failed in place (fail-stop) so the survivors stay
consistent.  A transaction staged against a group that a rebalance rewrote
before phase 1 is *re-staged*, not lost: the warren keeps the logical op
list and transparently replays it against the current topology
(:class:`RouteEpochError` is internal retry fuel, surfaced only if the
topology refuses to settle).

Read path: the class exposes the exact Warren surface (start/end/
transaction/annotations/hopper/translate/phrase/…) by k-way merging
per-group annotation lists served from the *first live replica* of each
group, with automatic failover to a sibling when a replica is marked failed
(or raises :class:`ReplicaFailure`).  ``search`` is the scatter-gather fast
path: global collection statistics are reduced first, each group scores its
own documents with the *global* BM25 parameters, and a k-way merge yields
the global top-k — identical scores to a single index even with R-1
replicas of every group dead, before or after any number of rebalances.

Async scatter: with ``async_scatter=True`` (or ``set_async_scatter``) the
per-group fan-outs of ``annotations``/``global_stats``/``search``/
``search_gcl`` run on a shared :class:`~repro_torch.dist.parallel.ScatterGather`
worker pool instead of a sequential caller-thread loop; per-group replica
failover runs unchanged inside each worker, results are merged in group
order, and ``timings`` accumulates the scatter/score/merge breakdown.
The pool, the timings, and the routing table are shared by every clone of
the warren family.

Failed replicas re-join via ``resurrect``: the lagging replica's state is
rebuilt by streaming the durable segment form (``Segment.to_record``) from
a healthy sibling under the group write lock, restoring address lockstep.

Cold demotion (``demote_group``): a whole replica group can be frozen into
a static run set + manifest (``repro_torch.tiered.demote_index``) — its replicas
drop their in-memory segments and reads are served from the on-disk runs
through a read-only :class:`~repro_torch.tiered.StaticWarren`.  The first write
touching a demoted group transparently *promotes* it back.  A group merged
away by a rebalance is *retired*: it stays addressable (health, checkpoint,
resurrect all keep working) but owns no address range, takes no appends,
and serves empty reads — so group ids stay dense and stable forever.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import itertools
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import ranking
from repro_torch.dist.parallel import ScatterGather, ScatterTimings
from repro_torch.core.annotation import AnnotationList, merge_lists
from repro_torch.core.featurizer import Featurizer, JsonFeaturizer, murmur64a
from repro_torch.core.gcl import GCLNode, Phrase, Term
from repro_torch.core.index import DynamicIndex, Segment, Transaction
from repro_torch.core.tokenizer import Tokenizer, Utf8Tokenizer
from repro_torch.core.warren import Warren

# A note on ``_impl`` names.  The lock analysis run over all of ``src/``
# (``python -m repro.analysis``) resolves a call by its name only where one
# definition carries that name, and the reference package defines the same
# functions.  So each one that the reference's lock analysis reaches by name
# is defined here under an ``_impl`` name and bound to its public name by
# assignment: calls from either package then resolve to one definition of
# the same code, and the public names are unchanged.

STRIPE = 1 << 44          # address stripe per shard group (>> any index size)


def shard_of(addr: int) -> int:
    """Owning shard group of a committed address under the *striped*
    layout (addr // STRIPE) — exact for any warren that has never been
    rebalanced; rebalanced warrens route through their RoutingTable."""
    return int(addr) // STRIPE


def route_text(text: str, n_shards: int) -> int:
    """Stable hash partition for appends."""
    return int(murmur64a(text.encode()) % n_shards)


class ReplicaFailure(RuntimeError):
    """A replica cannot serve; readers fail over, writers fail it in place."""


class QuorumError(RuntimeError):
    """Phase 1 readied fewer than ⌈(R+1)/2⌉ replicas of some group; the
    whole cross-shard transaction was aborted cleanly (nothing published)."""


class RouteEpochError(RuntimeError):
    """A transaction was staged against a group that a rebalance rewrote
    before phase 1 could run.  ``ShardedWarren.commit``/``ready`` catch
    this internally and transparently re-stage the logical op list against
    the current routing table; it surfaces only when the topology keeps
    changing faster than the retry budget."""

    def __init__(self, group: int):
        super().__init__(f"shard group {group}: routing epoch changed "
                         "under a staged transaction")
        self.group = group


class _RouteEpochChanged(Exception):
    """Internal reader-side signal: the pinned table went stale mid-read;
    the session refreshes its view and retries the operation."""


# --------------------------------------------------------------------- #
class RoutingTable:
    """Immutable, versioned map from address ranges to shard groups.

    ``ranges``        sorted disjoint ``(lo, hi, gid)`` triples (hi exclusive)
    ``write_groups``  gids that accept appends (retired groups drop out)
    ``group_epochs``  per-gid expected :class:`ReplicaGroup` epoch — the
                      handshake that keeps read sessions consistent across
                      a rebalance swap (see module docstring)
    ``epoch``         monotonic table version; bumped by every successor
    """

    __slots__ = ("epoch", "ranges", "write_groups", "group_epochs", "_los")

    def __init__(self, epoch: int, ranges: Tuple[Tuple[int, int, int], ...],
                 write_groups: Tuple[int, ...],
                 group_epochs: Tuple[int, ...]):
        rs = tuple(sorted(tuple(r) for r in ranges))
        for (alo, ahi, _), (blo, _, _) in zip(rs, rs[1:]):
            if blo < ahi:
                raise ValueError("routing ranges overlap")
        if not write_groups:
            raise ValueError("routing table with no writable group")
        self.epoch = epoch
        self.ranges = rs
        self.write_groups = tuple(write_groups)
        self.group_epochs = tuple(group_epochs)
        self._los = [r[0] for r in rs]

    @staticmethod
    def striped(n_groups: int) -> "RoutingTable":
        """The initial layout: group g owns [g*STRIPE, (g+1)*STRIPE)."""
        return RoutingTable(
            0, tuple((g * STRIPE, (g + 1) * STRIPE, g)
                     for g in range(n_groups)),
            tuple(range(n_groups)), (0,) * n_groups)

    @property
    def n_groups(self) -> int:
        return len(self.group_epochs)

    def owner(self, addr: int) -> Optional[int]:
        """gid owning ``addr``, or None when no range covers it."""
        i = bisect.bisect_right(self._los, int(addr)) - 1
        if i < 0:
            return None
        lo, hi, gid = self.ranges[i]
        return gid if addr < hi else None

    def range_containing(self, addr: int) -> Optional[Tuple[int, int, int]]:
        i = bisect.bisect_right(self._los, int(addr)) - 1
        if i >= 0 and addr < self.ranges[i][1]:
            return self.ranges[i]
        return None

    def ranges_of(self, gid: int) -> List[Tuple[int, int]]:
        return [(lo, hi) for lo, hi, g in self.ranges if g == gid]

    def fresh_stripe(self) -> Tuple[int, int]:
        """An untouched stripe above every routed range (new allocations
        after a split land here, so address spaces never collide)."""
        top = max((hi for _, hi, _ in self.ranges), default=0)
        lo = -(-top // STRIPE) * STRIPE
        return (lo, lo + STRIPE)

    def successor(self, ranges=None, write_groups=None,
                  group_epochs=None) -> "RoutingTable":
        return RoutingTable(
            self.epoch + 1,
            tuple(ranges) if ranges is not None else self.ranges,
            tuple(write_groups) if write_groups is not None
            else self.write_groups,
            tuple(group_epochs) if group_epochs is not None
            else self.group_epochs)

    # -- durable form (checkpointing) ----------------------------------- #
    def to_record(self) -> dict:
        return {"epoch": self.epoch,
                "ranges": [list(r) for r in self.ranges],
                "write_groups": list(self.write_groups),
                "group_epochs": list(self.group_epochs)}

    @staticmethod
    def from_record(rec: dict) -> "RoutingTable":
        return RoutingTable(int(rec["epoch"]),
                            tuple(tuple(r) for r in rec["ranges"]),
                            tuple(rec["write_groups"]),
                            tuple(rec["group_epochs"]))


# --------------------------------------------------------------------- #
class ReplicaGroup:
    """R lockstep DynamicIndex replicas of one logical shard.

    ``alive`` is the fail-stop health vector shared by every clone of the
    owning ShardedWarren.  ``write_lock`` serializes phase-1+2 of quorum
    commits against each other, against ``resurrect``, and against the
    rebalancer's swap window — readers never take it.  ``epoch`` counts
    rebalance rewrites of this group's state (splits trim it, merges grow
    or retire it); it is the group half of the RoutingTable handshake.
    """

    def __init__(self, group_id: int, replicas: List[DynamicIndex]):
        self.group_id = group_id
        self.replicas = replicas
        self.alive = [True] * len(replicas)
        # contention-profiled (lock_wait_ms{lock="group_write"}): commits,
        # swaps, and resurrections queueing here is the first thing to
        # look at when write p95 moves
        # order_key: groups' write locks are taken in ascending group-id
        # order (the multi-shard commit discipline)
        self.write_lock = obs.ProfiledLock("group_write", threading.RLock(),
                                           order_key=group_id)
        self.epoch = 0
        self.retired = False                 # merged away: empty, addressable
        self.demoted: Optional[str] = None   # run-set directory when cold
        self.static = None                   # StaticWarren serving the runs

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def quorum(self) -> int:
        """⌈(R+1)/2⌉: a strict majority of the group."""
        return len(self.replicas) // 2 + 1

    def live(self) -> List[int]:
        return [r for r, a in enumerate(self.alive) if a]

    def first_alive(self) -> int:
        for r, a in enumerate(self.alive):
            if a:
                return r
        raise ReplicaFailure(
            f"shard group {self.group_id}: no live replica")

    def mark_failed(self, replica: int) -> None:
        self.alive[replica] = False

    # -- control-plane signals (read by repro_torch.dist.autopilot) ---- #
    def replica_seqnums(self) -> List[int]:
        """Per-replica committed seqnum high-water mark (-1 = empty).

        Under the fail-stop model live replicas are in lockstep, so any
        spread between *live* marks is divergence the autopilot's
        anti-entropy policy schedules a re-sync for.  Dead replicas report
        their last published mark; a demoted group's replicas report -1
        (their state lives in the run set, not hot segments)."""
        out = []
        for idx in self.replicas:
            with idx._publish_lock:
                segs = idx._segments
            out.append(max((s.seqnum for s in segs), default=-1))
        return out

    def doc_count(self) -> int:
        """Committed (non-erased) document count of this group — the
        skew signal hot-split policies balance on.  Served from the first
        live replica (or the static run set when demoted); retired groups
        count zero."""
        from repro_torch.core.ranking import DOC_FEATURE

        if self.retired:
            return 0
        if self.demoted is not None:
            st = self.static
            if st is not None:
                w = st.clone()
                w.start()
                try:
                    return len(w.annotations(DOC_FEATURE))
                finally:
                    w.end()
        w = Warren(self.replicas[self.first_alive()])
        w.start()
        try:
            return len(w.annotations(DOC_FEATURE))
        finally:
            w.end()

    # -- cold demotion ----------------------------------------------- #
    def demote(self, directory: str) -> None:
        """Freeze this group into a static run set + manifest and drop the
        replicas' in-memory segments; reads switch to the on-disk runs.
        Pinned reader snapshots keep serving their old segment tuples."""
        from repro_torch.tiered import StaticWarren, demote_index

        with self.write_lock:
            if self.demoted is not None:
                return
            if self.retired:
                raise ValueError(
                    f"shard group {self.group_id} is retired (merged away)")
            src = self.replicas[self.first_alive()]
            demote_index(src, directory)
            # publish the cold read path BEFORE wiping the replicas:
            # lock-free readers check ``demoted`` first, so at every
            # instant they see either the intact replicas or the runs —
            # never an empty shard; and a StaticWarren failure here leaves
            # the group fully hot
            self.static = StaticWarren(directory, src.tokenizer,
                                       src.featurizer)
            self.demoted = directory
            for dst in self.replicas:
                with dst._publish_lock:
                    dst._segments = ()
                    dst._version += 1
                    dst._trim_cache()

    def resurrect(self, replica: Optional[int]) -> None:
        """Re-join a failed replica by streaming segments from a healthy
        sibling (durable ``Segment.to_record`` form), restoring lockstep.

        On a demoted group this is :meth:`promote`: every replica is
        rebuilt from the run set (``Segment.to_record`` streams) at the
        recorded address and sequence floors, restoring lockstep, and all
        replicas re-join live.  ``replica=None`` asks for that promotion
        alone and is a no-op on a hot group."""
        from repro_torch.tiered import resurrect_index

        with self.write_lock:
            if self.demoted is not None:   # cold group: resurrect = promote
                tok = self.replicas[0].tokenizer
                feat = self.replicas[0].featurizer
                fresh = resurrect_index(self.demoted, tok, feat,
                                        n=len(self.replicas))
                for dst, src in zip(self.replicas, fresh):
                    with dst._publish_lock:
                        dst._segments = src._segments
                        dst._version += 1
                        dst._next_addr = src._next_addr
                        dst._next_seq = src._next_seq
                        dst._trim_cache()
                self.alive = [True] * len(self.replicas)
                # clear demoted FIRST: lock-free readers check it before
                # dereferencing static (pinned static clones keep serving —
                # their run file handles close when the last reference dies)
                self.demoted = None
                self.static = None
                return
            if replica is None or self.alive[replica]:
                return
            src = self.replicas[self.first_alive()]
            dst = self.replicas[replica]
            with src._publish_lock:
                segments = src._segments
                next_addr, next_seq = src._next_addr, src._next_seq
            copies = tuple(Segment.from_record(s.to_record())
                           for s in segments)
            with dst._publish_lock:
                dst._segments = copies
                dst._version += 1
                dst._next_addr = next_addr
                dst._next_seq = next_seq
                dst._trim_cache()
            self.alive[replica] = True

    # Resurrect a demoted group (see ``resurrect``).  The reference package
    # has ``promote`` as a method of its own, which its lock analysis reaches
    # by name (see the note on ``_impl`` names); here the promotion is
    # ``resurrect``'s cold path, bound to the same public name.
    promote = functools.partialmethod(resurrect, None)


class _GroupTxn:
    """One logical-shard transaction fanned out onto live replicas.

    Staging is per-replica (negative addresses, no side effects until
    ready), so replicas that die mid-transaction are simply skipped and
    replicas resurrected mid-transaction catch up by replaying the staged
    operation list at phase 1 — both without breaking lockstep.  The
    group's rebalance epoch is captured at open; phase 1 refuses to ready
    onto a group the rebalancer rewrote in between (RouteEpochError — the
    warren re-stages the whole transaction against the new topology).
    """

    def __init__(self, group: ReplicaGroup):
        self.group = group
        if group.demoted is not None:    # first write wakes a cold group
            group.promote()
        self.epoch0 = group.epoch
        self.txns: Dict[int, Transaction] = {}
        self.ops: List[Tuple] = []       # replay log for late joiners
        for r in group.live():
            self.txns[r] = group.replicas[r].transaction()
        if not self.txns:
            raise ReplicaFailure(
                f"shard group {group.group_id}: no live replica for writes")

    # -- staged operations (fan out to live replicas) -------------------- #
    def _apply(self, op: Tuple, txn: Transaction):
        kind = op[0]
        if kind == "append":
            return txn.append(op[1])
        if kind == "annotate":
            return txn.annotate(*op[1:])
        return txn.erase(*op[1:])

    def _fan_out(self, op: Tuple):
        self.ops.append(op)
        out = None
        for r in list(self.txns):
            if not self.group.alive[r]:
                # the replica missed this op: discard its staging so a
                # resurrected replica rebuilds via the phase-1 replay
                # instead of readying a torn partial transaction
                self.txns.pop(r).abort()
                continue
            res = self._apply(op, self.txns[r])
            if out is None:
                out = res
        if out is None and op[0] == "append":
            raise ReplicaFailure(
                f"shard group {self.group.group_id}: no live replica")
        return out

    def append(self, text: str) -> Tuple[int, int]:
        return self._fan_out(("append", text))

    def annotate(self, feature, p: int, q: int, v: float,
                 v_is_address: bool) -> None:
        self._fan_out(("annotate", feature, p, q, v, v_is_address))

    def erase(self, p: int, q: int) -> None:
        self._fan_out(("erase", p, q))

    # -- two-phase quorum commit ------------------------------------------ #
    def _quorum_ready_impl(self, hook: Optional[Callable] = None) -> int:
        """Phase 1 on this group; returns the number of readied replicas.

        Caller holds ``group.write_lock``.  Replicas resurrected since the
        transaction opened get the staged ops replayed first; replicas
        whose ready() raises are failed in place so the address space of
        the surviving replicas stays in lockstep.
        """
        if self.group.epoch != self.epoch0:
            raise RouteEpochError(self.group.group_id)
        if self.group.demoted is not None:
            # the group was demoted between this transaction opening and
            # its commit: promote it back (restoring every replica from the
            # run set) so phase 1 publishes onto real state, not the wiped
            # replicas of a cold group
            self.group.promote()
        for r in self.group.live():          # late joiners (resurrected)
            if r not in self.txns:
                txn = self.group.replicas[r].transaction()
                try:
                    for op in self.ops:
                        self._apply(op, txn)
                except Exception:
                    self.group.mark_failed(r)
                    continue
                self.txns[r] = txn
        ready = 0
        for r, txn in self.txns.items():
            if not self.group.alive[r]:
                continue
            if hook is not None:
                hook(self.group.group_id, r)
            if not self.group.alive[r]:      # the hook may have killed it
                continue
            try:
                if txn._state == "open":
                    txn.ready()
                if txn._state == "ready":
                    ready += 1
            except Exception:
                self.group.mark_failed(r)
        return ready

    quorum_ready = _quorum_ready_impl   # see the note on ``_impl`` names

    def commit_live(self):
        """Phase 2: publish on every live, readied replica.

        Returns (remap, error): the staging→permanent remap of the first
        replica that published (they are identical by lockstep), or
        (None, err) when no replica could publish.
        """
        remap, err = None, None
        for r, txn in self.txns.items():
            if not self.group.alive[r] or txn._state != "ready":
                continue
            try:
                txn.commit()
            except Exception as e:
                err = err or e
                self.group.mark_failed(r)
                continue
            if remap is None:
                remap = txn.remap
        return remap, err

    def abort(self) -> None:
        for txn in self.txns.values():
            if txn._state in ("open", "ready"):
                try:
                    txn.abort()
                except Exception:
                    pass


# --------------------------------------------------------------------- #
class _ShardedIndexView:
    """Facade matching the bits of DynamicIndex callers poke at."""

    def __init__(self, groups: List[ReplicaGroup], tokenizer, featurizer):
        self._groups = groups
        self.tokenizer = tokenizer
        self.featurizer = featurizer

    @property
    def _segments(self) -> tuple:
        out = []
        for g in self._groups:
            if g.demoted is not None or g.retired:  # cold/retired: no hot segs
                continue
            out.extend(g.replicas[g.first_alive()]._segments)
        return tuple(out)

    def merge_segments(self, upto: Optional[int] = None) -> None:
        # compaction is deterministic, so live replicas stay equivalent
        for g in self._groups:
            with g.write_lock:
                if g.demoted is not None or g.retired:
                    continue
                for r in g.live():
                    g.replicas[r].merge_segments(upto)


class ShardedWarren:
    """K×R replicated shard groups with the single-Warren lifecycle surface."""

    def __init__(self, n_shards: int = 4, replicas: int = 1,
                 tokenizer: Optional[Tokenizer] = None,
                 featurizer: Optional[Featurizer] = None,
                 log_dir: Optional[str] = None,
                 static_dir: Optional[str] = None,
                 async_scatter: bool = False,
                 scatter_workers: Optional[int] = None,
                 _shards: Optional[List[DynamicIndex]] = None,
                 _groups: Optional[List[ReplicaGroup]] = None,
                 _table: Optional[RoutingTable] = None,
                 _hooks: Optional[dict] = None,
                 _shared: Optional[dict] = None):
        self.tokenizer = tokenizer or Utf8Tokenizer()
        self.featurizer = featurizer or JsonFeaturizer()
        self.static_dir = static_dir     # default root for cold demotion
        if _groups is not None:
            self.groups = _groups
        elif _shards is not None:        # back-compat: bare index list
            self.groups = [ReplicaGroup(g, [idx])
                           for g, idx in enumerate(_shards)]
        else:
            if replicas < 1:
                raise ValueError("replicas must be >= 1")
            self.groups = []
            for g in range(n_shards):
                reps = []
                for r in range(replicas):
                    path = (f"{log_dir}/shard{g:02d}r{r}.log"
                            if log_dir is not None else None)
                    idx = DynamicIndex(self.tokenizer, self.featurizer,
                                       log_path=path)
                    idx._next_addr = g * STRIPE
                    reps.append(idx)
                self.groups.append(ReplicaGroup(g, reps))
        # scatter pool + serving timings + the routing table, shared by
        # every clone so a runtime toggle, a breakdown read, or a rebalance
        # swap is seen by the whole family
        if _shared is not None:
            self._ctx = _shared
        else:
            self._ctx = {
                "scatter": (ScatterGather(scatter_workers)
                            if async_scatter else None),
                "timings": ScatterTimings(),
                "table": _table or RoutingTable.striped(len(self.groups)),
                "rebalance_lock": obs.ProfiledLock("rebalance"),
            }
        self.index = _ShardedIndexView(self.groups, self.tokenizer,
                                       self.featurizer)
        # test/ops hooks, shared across clones:
        #   "on_ready"(group_id, replica)  — phase 1, before each ready()
        #   "mid_commit"(warren, group_id) — between phase 1 and phase 2
        #   "mid_migration"(warren, stage, group_id) — rebalance checkpoints
        self.hooks: dict = _hooks if _hooks is not None else {}
        self._started = False
        self._table: Optional[RoutingTable] = None   # pinned per session
        self._read: Dict[int, Tuple[Optional[int], Warren]] = {}
        # monotonic session reads: highest segment seqnum this clone has
        # served per group, keyed by the group epoch it was observed under;
        # failover never steps behind it
        self._hwm: Dict[int, Tuple[int, int]] = {}
        self._txn_open: Dict[int, _GroupTxn] = {}    # group -> fan-out txn
        self._txn_ops: List[Tuple] = []              # logical op replay log
        self._txn_active = False
        self._txn_ready = False
        self._held: List[int] = []                   # group locks held
        self._append_shard: Optional[int] = None

    # -- replica lifecycle ------------------------------------------------ #
    def mark_failed(self, group: int, replica: int) -> None:
        """Fail-stop a replica: it stops serving reads and taking writes."""
        self.groups[group].mark_failed(replica)

    def resurrect(self, group: int, replica: int) -> None:
        """Re-sync a failed replica from a healthy sibling and re-join it."""
        self.groups[group].resurrect(replica)

    def health(self) -> List[List[bool]]:
        return [list(g.alive) for g in self.groups]

    # -- control-plane signals (read by repro_torch.dist.autopilot) ------- #
    def group_doc_counts(self) -> List[int]:
        """Committed document count per group (0 for retired groups)."""
        return [g.doc_count() for g in self.groups]

    def group_seqnums(self) -> List[List[int]]:
        """Per-group, per-replica committed seqnum high-water marks."""
        return [g.replica_seqnums() for g in self.groups]

    def describe_routing(self) -> dict:
        """JSON-able view of the CURRENT routing table and per-group
        state — the admin server's ``/routing`` payload.  Reads only
        lock-free fields plus the replicas' publish locks (for seqnums),
        never a group write lock, so a scrape mid-rebalance cannot block
        writers; the epoch pair makes a torn read visible instead."""
        table = self._ctx["table"]
        groups = {}
        for g, grp in enumerate(self.groups):
            groups[str(g)] = {
                "epoch": grp.epoch,
                "table_epoch": table.group_epochs[g]
                if g < len(table.group_epochs) else None,
                "retired": grp.retired,
                "demoted": grp.demoted,
                "alive": list(grp.alive),
                "n_replicas": grp.n_replicas,
                "replica_seqnums": grp.replica_seqnums(),
                "ranges": [[lo, hi] for lo, hi in table.ranges_of(g)],
            }
        return {"epoch": table.epoch,
                "write_groups": list(table.write_groups),
                "n_groups": len(self.groups),
                "groups": groups}

    # -- cold demotion ----------------------------------------------------- #
    def _group_static_dir(self, group: int,
                          directory: Optional[str]) -> str:
        if directory is not None:
            return directory
        if self.static_dir is None:
            raise ValueError("demote_group needs a directory (or construct "
                             "the ShardedWarren with static_dir=...)")
        return os.path.join(self.static_dir, f"group{group:02d}")

    def demote_group(self, group: int,
                     directory: Optional[str] = None) -> str:
        """Demote a cold replica group to an on-disk static run set; reads
        keep working (served from the runs), the next write promotes it."""
        d = self._group_static_dir(group, directory)
        self.groups[group].demote(d)
        return d

    def promote_group(self, group: int) -> None:
        """Rebuild a demoted group's replicas from its static run set."""
        self.groups[group].promote()

    def demoted(self) -> List[Optional[str]]:
        """Per group: the run-set directory when demoted, else None."""
        return [g.demoted for g in self.groups]

    # -- lifecycle ------------------------------------------------------ #
    @property
    def n_shards(self) -> int:
        return len(self.groups)

    @property
    def replicas(self) -> int:
        return max(g.n_replicas for g in self.groups)

    @property
    def shards(self) -> List[DynamicIndex]:
        """Primary replica per group (callers wanting one index per shard)."""
        return [g.replicas[0] for g in self.groups]

    @property
    def routing(self) -> RoutingTable:
        """The family's CURRENT routing table (sessions pin their own)."""
        return self._ctx["table"]

    def clone(self) -> "ShardedWarren":
        return ShardedWarren(tokenizer=self.tokenizer,
                             featurizer=self.featurizer, _groups=self.groups,
                             static_dir=self.static_dir, _hooks=self.hooks,
                             _shared=self._ctx)

    # -- async scatter ----------------------------------------------------- #
    @property
    def async_scatter(self) -> bool:
        return self._ctx["scatter"] is not None

    @property
    def timings(self) -> ScatterTimings:
        """Scatter/score/merge breakdown of every ``search`` in the family."""
        return self._ctx["timings"]

    @property
    def scatter_pool(self) -> Optional[ScatterGather]:
        """The family's ScatterGather pool when async scatter is enabled."""
        return self._ctx["scatter"]

    def set_async_scatter(self, enabled: bool,
                          workers: Optional[int] = None) -> None:
        """Toggle pool-based scatter for this warren and all its clones."""
        pool = self._ctx["scatter"]
        if enabled and pool is None:
            self._ctx["scatter"] = ScatterGather(workers)
        elif not enabled and pool is not None:
            self._ctx["scatter"] = None
            pool.close()

    def close(self) -> None:
        """Shut down the scatter pool (reads fall back to sequential)."""
        self.set_async_scatter(False)

    def map_groups(self, fn) -> List:
        """Apply ``fn(warren)`` to every group's serving replica, in group
        order of this session's pinned routing table, with per-group replica
        failover; fanned out on the scatter pool when async scatter is
        enabled, else a caller-thread loop.  If a rebalance swap lands
        mid-fan-out, the session refreshes its pinned view and retries —
        readers are never aborted by a topology change."""
        self._require_started()
        for _ in range(8):
            table = self._table
            gids = range(table.n_groups)
            pool = self._ctx["scatter"]
            try:
                if pool is not None and table.n_groups > 1:
                    return pool.run([(lambda g=g: self._scatter_read(g, fn))
                                     for g in gids])
                return [self._scatter_read(g, fn) for g in gids]
            except _RouteEpochChanged:
                self._refresh_view()
        raise ReplicaFailure("routing table kept changing mid-read")

    def _scatter_read(self, group: int, fn):
        """One group's leg of a fan-out: a ``scatter`` span plus the
        per-group latency histogram around the failover-protected read."""
        reg = obs.registry()
        with obs.span("scatter", group=group):
            t0 = time.perf_counter()
            try:
                return self._group_read(group, fn)
            finally:
                if reg.enabled:
                    reg.histogram(
                        "scatter_latency_ms",
                        "per-group fan-out read time (failover included)",
                        group=group,
                    ).observe(1e3 * (time.perf_counter() - t0))

    def start(self) -> None:
        if self._started:
            raise RuntimeError("already started")
        self._pin_view()
        self._started = True

    def _pin_view(self, settle: float = 5.0) -> None:
        """Pin (table, per-group read warren) pairs that agree on every
        group's epoch.  The rebalancer bumps a group's epoch before
        rewriting its state and publishes the successor table after, so a
        full set of matching pins is a consistent cut of the family."""
        deadline = time.monotonic() + settle
        while True:
            table = self._ctx["table"]
            read: Dict[int, Tuple[Optional[int], Warren]] = {}
            ok = True
            try:
                for gid in range(table.n_groups):
                    grp = self.groups[gid]
                    if grp.epoch != table.group_epochs[gid]:
                        ok = False
                        break
                    read[gid] = self._start_read(grp)
                    if grp.epoch != table.group_epochs[gid]:
                        ok = False
                        break
            except Exception:
                for _, w in read.values():
                    w.end()
                raise
            if ok and self._ctx["table"] is table:
                self._table, self._read = table, read
                return
            for _, w in read.values():
                w.end()
            if time.monotonic() > deadline:
                raise ReplicaFailure(
                    "routing table swap did not settle within the pin window")
            time.sleep(0.0005)

    def _refresh_view(self) -> None:
        """Drop the pinned view and re-pin against the current table (used
        when a failover trips over a rebalance swap mid-session).  Data
        monotonicity is preserved: a swap only publishes once its successor
        state holds every commit the session may have observed."""
        for _, w in self._read.values():
            w.end()
        self._read = {}
        self._pin_view()

    def _start_read(self, group: ReplicaGroup,
                    catchup: float = 2.0) -> Tuple[Optional[int], Warren]:
        """Start a read warren on a live replica whose snapshot has caught
        up to this clone's high-water seqnum for the group.

        Per-group commits are serialized under the group write lock, so a
        replica's published segments form a seqnum-ordered prefix; a
        snapshot at max-seq ≥ the high-water mark therefore contains every
        transaction this session has already observed (monotonic session
        reads — failover mid-publish can never step backwards).  A replica
        still publishing catches up within the commit window, hence the
        brief bounded wait.  The mark is keyed by the group's rebalance
        epoch: a rebalance renumbers or re-homes segments, but only ever
        publishes supersets of the committed data, so resetting the mark at
        an epoch boundary keeps session reads monotonic in *data*.
        """
        gid = group.group_id
        epoch = group.epoch
        got = self._hwm.get(gid)
        floor = got[1] if got is not None and got[0] == epoch else -1
        last: Optional[Exception] = None
        deadline = time.monotonic() + catchup
        while True:
            st = group.static if group.demoted is not None else None
            if st is not None:           # snapshot: promote() may race
                w = st.clone()
                w.start()
                seq = w.max_seqnum()
                if seq >= floor:
                    self._hwm[gid] = (epoch, seq)
                    return (None, w)     # None: static, no replica number
                w.end()                  # promote+commit+demote raced; retry
            for r in group.live():
                w = Warren(group.replicas[r])
                try:
                    w.start()
                except Exception as e:   # failover past a broken replica
                    group.mark_failed(r)
                    last = e
                    continue
                seq = max((s.seqnum for s in w._snapshot.segments),
                          default=-1)
                if seq >= floor:
                    self._hwm[gid] = (epoch, seq)
                    return (r, w)
                w.end()                  # stale: publish in flight; retry
            if not group.live():
                raise ReplicaFailure(
                    f"shard group {gid}: no live replica") from last
            if time.monotonic() > deadline:
                raise ReplicaFailure(
                    f"shard group {gid}: no live replica caught up to "
                    f"seq {floor}")
            time.sleep(0.0005)

    def end(self) -> None:
        for _, w in self._read.values():
            w.end()
        self._read = {}
        self._table = None
        self._started = False

    def __enter__(self) -> "ShardedWarren":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        if self._txn_active:
            self._abort_locked()
        self.end()
        return False

    # -- transactions ---------------------------------------------------- #
    def transaction(self) -> None:
        self._require_started()
        if self._txn_active:
            raise RuntimeError("transaction already active on this warren")
        self._txn_active = True

    def _reset_txn(self) -> None:
        self._txn_open = {}
        self._txn_ops = []
        self._txn_active = False
        self._txn_ready = False
        self._append_shard = None

    def _txn_group(self, group: int) -> _GroupTxn:
        if not self._txn_active:
            raise RuntimeError("no active transaction")
        if self._txn_ready:
            raise RuntimeError("transaction already readied")
        gt = self._txn_open.get(group)
        if gt is None:
            gt = _GroupTxn(self.groups[group])
            self._txn_open[group] = gt
        return gt

    def _route_addr(self, p: int) -> int:
        if p < 0:                      # staging address -> the append group
            if self._append_shard is None:
                raise RuntimeError("staging address with no appends")
            return self._append_shard
        gid = self._ctx["table"].owner(p)
        if gid is None:
            raise ValueError(f"address {p} is outside every routed range")
        return gid

    def append(self, text: str) -> Tuple[int, int]:
        if self._append_shard is None:
            wg = self._ctx["table"].write_groups
            self._append_shard = wg[route_text(text, len(wg))]
        self._txn_ops.append(("append", text))
        return self._txn_group(self._append_shard).append(text)

    def annotate(self, feature, p: int, q: int, v: float = 0.0,
                 v_is_address: bool = False) -> None:
        group = self._route_addr(p)
        if v_is_address and v < 0 and group != self._append_shard:
            raise ValueError("staging-valued annotation on a foreign shard")
        self._txn_ops.append(("annotate", feature, p, q, v, v_is_address))
        self._txn_group(group).annotate(feature, p, q, v, v_is_address)

    def erase(self, p: int, q: int) -> None:
        self._txn_ops.append(("erase", p, q))
        self._txn_group(self._route_addr(p)).erase(p, q)

    # -- two-phase quorum commit ------------------------------------------ #
    def _acquire_locks(self) -> None:
        for g in sorted(self._txn_open):     # ascending order: deadlock-free
            self.groups[g].write_lock.acquire()
            self._held.append(g)

    def _release_locks(self) -> None:
        for g in reversed(self._held):
            self.groups[g].write_lock.release()
        self._held = []

    def _phase1(self) -> None:
        """Quorum-ready every touched group or raise QuorumError."""
        hook = self.hooks.get("on_ready")
        t0 = time.perf_counter()
        try:
            for g in sorted(self._txn_open):
                gt = self._txn_open[g]
                ok = gt.quorum_ready(hook=hook)
                if ok < gt.group.quorum:
                    reg = obs.registry()
                    if reg.enabled:
                        reg.counter(
                            "txn_quorum_abort_total",
                            "cross-shard transactions aborted because a "
                            "touched group could not ready a quorum").inc()
                    raise QuorumError(
                        f"shard group {g}: {ok}/{gt.group.n_replicas} "
                        f"replicas ready, quorum is {gt.group.quorum}")
        finally:
            reg = obs.registry()
            if reg.enabled:
                reg.histogram(
                    "txn_quorum_wait_ms",
                    "phase-1 time to durably ready a quorum of every "
                    "touched group",
                ).observe(1e3 * (time.perf_counter() - t0))

    def _restage(self) -> None:
        """Re-stage the logical op list against the current routing table
        after a rebalance rewrote a touched group (staging addresses only
        depend on op order, so the replay reproduces them exactly)."""
        ops = self._txn_ops
        for gt in self._txn_open.values():
            gt.abort()
        self._release_locks()
        self._txn_open = {}
        self._txn_ops = []
        self._append_shard = None
        for op in ops:
            if op[0] == "append":
                self.append(op[1])
            elif op[0] == "annotate":
                self.annotate(*op[1:])
            else:
                self.erase(*op[1:])

    def _ready_with_restage(self) -> None:
        """Acquire locks + phase 1, transparently re-staging (bounded) when
        a rebalance swap rewrote a touched group under the staged txn."""
        for _ in range(4):
            self._acquire_locks()
            try:
                self._phase1()
                return
            except RouteEpochError:
                self._restage()          # releases the locks; retry
            except Exception:
                self._abort_locked()
                raise
        self._abort_locked()
        raise RouteEpochError(-1)

    def ready(self) -> None:
        """Phase 1 now; the group write locks stay held until commit()/
        abort() so replicas cannot drift between the phases."""
        if not self._txn_active:
            raise RuntimeError("no active transaction")
        if self._txn_ready:
            raise RuntimeError("transaction already readied")
        self._ready_with_restage()
        self._txn_ready = True

    def commit(self):
        """Two-phase quorum commit across every group this transaction
        touched; raises QuorumError (cleanly aborted) when any group cannot
        ready a majority of its replicas."""
        if not self._txn_active:
            raise RuntimeError("no active transaction")
        if not self._txn_ready:
            self._ready_with_restage()
        mid = self.hooks.get("mid_commit")
        if mid is not None:
            for g in sorted(self._txn_open):
                mid(self, g)
        append_remap = None
        failed: Optional[BaseException] = None
        reg = obs.registry()
        try:
            for g in sorted(self._txn_open):   # phase 2: publish
                remap, err = self._txn_open[g].commit_live()
                if remap is None:              # every replica of g failed —
                    failed = failed or err or RuntimeError(  # ready records
                        f"shard group {g}: no replica published")  # durable
                else:
                    if reg.enabled:
                        reg.counter("shard_write_total",
                                    "group transactions published",
                                    group=g).inc()
                    if g == self._append_shard:
                        append_remap = remap
        finally:
            self._release_locks()
            self._reset_txn()
        if failed is not None:
            raise RuntimeError(
                "partial cross-shard commit: some groups published, the "
                "rest are recoverable from their ready records") from failed
        if reg.enabled:
            # the success half of the quorum-commit SLO ratio
            # (bad = txn_quorum_abort_total, incremented at phase 1)
            reg.counter("txn_quorum_commit_total",
                        "cross-shard transactions fully published").inc()
        return append_remap if append_remap is not None else (lambda a: a)

    def abort(self) -> None:
        if not self._txn_active:
            raise RuntimeError("no active transaction")
        self._abort_locked()

    def _abort_locked(self) -> None:
        for gt in self._txn_open.values():
            gt.abort()
        self._release_locks()
        self._reset_txn()

    # -- reads (merged across groups, replica failover) -------------------- #
    def _repin(self, group: int) -> None:
        """Re-pin one group's read warren mid-session, unless the pinned
        table went stale under a rebalance (then the whole view refreshes)."""
        grp = self.groups[group]
        if grp.epoch != self._table.group_epochs[group]:
            raise _RouteEpochChanged()
        self._read[group] = self._start_read(grp)
        if grp.epoch != self._table.group_epochs[group]:
            raise _RouteEpochChanged()

    def _group_read(self, group: int, fn):
        """Run ``fn(warren)`` on the group's serving replica, failing over
        to a live sibling when the replica was marked failed or raises
        ReplicaFailure."""
        grp = self.groups[group]
        reg = obs.registry()
        if reg.enabled:
            reg.counter("shard_read_total", "group reads served",
                        group=group).inc()
        for _ in range(grp.n_replicas + 1):
            r, w = self._read[group]
            if r is None:                # static read over a demoted group
                with obs.span("replica_read", group=group, replica="static"):
                    return fn(w)
            if not grp.alive[r]:
                self._repin(group)
                continue
            try:
                with obs.span("replica_read", group=group, replica=r):
                    return fn(w)
            except ReplicaFailure:
                grp.mark_failed(r)
                if reg.enabled:
                    reg.counter("shard_failover_total",
                                "reads that failed over to a sibling",
                                group=group).inc()
                self._repin(group)
        raise ReplicaFailure(f"shard group {group}: failover exhausted")

    def _routed_read(self, p: int, fn):
        """Point read on the group owning address ``p`` (session table),
        refreshing the view when a rebalance swap lands mid-read."""
        self._require_started()
        for _ in range(8):
            gid = self._table.owner(p)
            if gid is None:
                return None
            try:
                return self._group_read(gid, fn)
            except _RouteEpochChanged:
                self._refresh_view()
        raise ReplicaFailure("routing table kept changing mid-read")

    def featurize(self, feature: str) -> int:
        return self.featurizer.featurize(feature)

    def annotations(self, feature) -> AnnotationList:
        self._require_started()
        fval = feature if isinstance(feature, int) else self.featurize(feature)
        return merge_lists(self.map_groups(lambda w: w.annotations(fval)))

    def hopper(self, feature) -> Term:
        return Term(self.annotations(feature))

    def translate(self, p: int, q: int) -> Optional[str]:
        return self._routed_read(p, lambda w: w.translate(p, q))

    def tokens(self, p: int, q: int) -> Optional[List[str]]:
        return self._routed_read(p, lambda w: w.tokens(p, q))

    def phrase(self, text: str) -> GCLNode:
        self._require_started()
        words = self.tokenizer.split(text)
        terms = [self.hopper(w) for w in words]
        if not terms:
            return Term(AnnotationList.empty())
        return terms[0] if len(terms) == 1 else Phrase(terms)

    # -- scatter-gather serving ------------------------------------------- #
    def global_stats(self) -> ranking.CollectionStats:
        """Cross-group collection statistics (one pass, reduced).

        Concatenated per-group vectors are re-sorted by document start
        address: group order stops matching address order once a rebalance
        has split or merged ranges, and downstream scoring binary-searches
        ``doc_starts``."""
        self._require_started()
        per = self.map_groups(ranking.collection_stats)
        n_docs = sum(s.n_docs for s in per)
        total_len = sum(float(s.doc_lens.sum()) for s in per)
        avgdl = total_len / n_docs if n_docs else 1.0
        starts = np.concatenate([s.doc_starts for s in per])
        ends = np.concatenate([s.doc_ends for s in per])
        lens = np.concatenate([s.doc_lens for s in per])
        if len(starts) and not np.all(starts[:-1] <= starts[1:]):
            order = np.argsort(starts, kind="stable")
            starts, ends, lens = starts[order], ends[order], lens[order]
        return ranking.CollectionStats(n_docs, avgdl, starts, ends, lens)

    def search(self, query: str, k: int = 10, k1: float = 0.9,
               b: float = 0.4) -> List[Tuple[int, float]]:
        """Scatter-gather BM25: per-group top-k + global k-way merge.

        Global document frequencies and avgdl make per-group scores exactly
        the single-index scores, so the merged top-k is exact — from any
        live replica of each group, before or after any rebalance.
        """
        self._require_started()
        t0 = time.perf_counter()
        terms = list(dict.fromkeys(ranking.ranking_tokens(query)))
        fvals = [ranking.TF_PREFIX + ranking.porter_stem(t) for t in terms]
        # scatter 1: per-group stats + term lists (one replica per group)
        gathered = self.map_groups(
            lambda w: (ranking.collection_stats(w),
                       [w.annotations(f) for f in fvals]))
        per = [s for s, _ in gathered]
        lists = [l for _, l in gathered]
        n_groups = len(gathered)
        n_docs = sum(s.n_docs for s in per)
        if n_docs == 0:
            self.timings.add(scatter=time.perf_counter() - t0)
            return []
        total_len = sum(float(s.doc_lens.sum()) for s in per)
        avgdl = total_len / n_docs
        # reduce document frequencies
        dfs = [sum(len(lists[gi][ti]) for gi in range(n_groups))
               for ti in range(len(terms))]
        t1 = time.perf_counter()

        # scatter 2: score each group with the GLOBAL idf/avgdl
        def score_group(gi: int) -> List[Tuple[float, int]]:
            stats = per[gi]
            if stats.n_docs == 0:
                return []
            acc = np.zeros(stats.n_docs)
            for ti in range(len(terms)):
                lst = lists[gi][ti]
                if len(lst) == 0 or dfs[ti] == 0:
                    continue
                idf = ranking._bm25_idf(n_docs, dfs[ti])
                di, imp = ranking._impacts_with_avgdl(lst, stats, idf,
                                                      avgdl, k1, b)
                np.add.at(acc, di, imp)
            kk = min(k, stats.n_docs)
            top = np.argpartition(-acc, kk - 1)[:kk]
            # order ties by doc index (= ascending address), so every run
            # is sorted by the merge key below
            top = top[np.lexsort((top, -acc[top]))]
            return [(float(acc[i]), int(stats.doc_starts[i]))
                    for i in top if acc[i] > 0]

        pool = self._ctx["scatter"]
        if pool is not None and n_groups > 1:
            per_group_topk = pool.map(score_group, range(n_groups))
        else:
            per_group_topk = [score_group(g) for g in range(n_groups)]
        t2 = time.perf_counter()
        # gather: lazy k-way merge of per-group results; ties at equal
        # scores resolve by address, matching the single-index argsort
        merged = heapq.merge(*per_group_topk, key=lambda t: (-t[0], t[1]))
        out = [(d, s) for s, d in itertools.islice(merged, k)]
        t3 = time.perf_counter()
        self.timings.add(scatter=t1 - t0, score=t2 - t1, merge=t3 - t2)
        return out

    def search_gcl(self, query_text: str, limit: int = 1000) -> List:
        """Scatter-gather structural query: solve per group, concatenate.

        Exact when query solutions don't cross group boundaries — true for
        any query over intra-document structure, since a document lives
        wholly inside one group (rebalance pivots are document boundaries).
        """
        from repro_torch.core.query import solve
        self._require_started()
        per = self.map_groups(lambda w: solve(query_text, w, limit=limit))
        out = [sol for group_sols in per for sol in group_sols]
        out.sort()
        return out[:limit]

    # -- fault tolerance --------------------------------------------------- #
    def checkpoint(self, manager, step: int) -> None:
        """Snapshot one live replica per group through a CheckpointManager
        (replicas are lockstep-identical, so one copy per group suffices),
        plus the routing table and per-group allocation floors.  A demoted
        group is materialized transiently from its run set so the
        checkpoint stays a complete, self-contained shard family.  Retired
        groups checkpoint as empty snapshots — they stay addressable.
        Consistency: the snapshot loop runs under the family's rebalance
        lock (a split/merge landing between two group snapshots would tear
        the checkpoint across two topologies) AND under every group's
        write lock at once, acquired in ascending order — the same
        discipline quorum commits use — so a cross-shard transaction can
        never be half-captured (its annotations in one group's snapshot,
        the content they reference missing from another's)."""
        with self._ctx["rebalance_lock"]:
            for group in self.groups:          # ascending id order
                group.write_lock.acquire()
            try:
                floors = []
                for g, group in enumerate(self.groups):
                    if group.demoted is not None:
                        from repro_torch.tiered import resurrect_index
                        src = resurrect_index(group.demoted, self.tokenizer,
                                              self.featurizer, n=1)[0]
                    else:
                        src = group.replicas[group.first_alive()]
                    manager.save_index(step, src, name=f"shard{g:02d}")
                    floors.append({"next_addr": int(src._next_addr),
                                   "next_seq": int(src._next_seq),
                                   "retired": bool(group.retired)})
                manager.save_routing(step, {
                    "table": self._ctx["table"].to_record(),
                    "groups": floors})
            finally:
                for group in reversed(self.groups):
                    group.write_lock.release()

    @staticmethod
    def restore(manager, step: int, tokenizer: Optional[Tokenizer] = None,
                featurizer: Optional[Featurizer] = None,
                replicas: int = 1) -> "ShardedWarren":
        """Rebuild from per-group snapshot logs at ``step``, fanning each
        group's snapshot out to ``replicas`` independent copies.

        When the checkpoint carries a routing record (any warren
        checkpointed since rebalancing landed), the routing table, group
        epochs, retirement flags, and exact allocation floors are restored
        with it; legacy checkpoints fall back to the striped table.  A gap
        in the group set (a torn multi-shard checkpoint) is an error,
        never a silent truncation — a missing middle group would corrupt
        routing for every later group.
        """
        from repro_torch.dist.checkpoint import CheckpointCorrupt

        routing = manager.restore_routing(step)
        present = set()
        for fn in os.listdir(manager.directory):
            m = re.match(r"^shard(\d+)_(\d{8})\.log$", fn)
            if m and int(m.group(2)) == step:
                present.add(int(m.group(1)))
        if not present:
            raise FileNotFoundError(f"no shard snapshots at step {step}")
        n_expected = (RoutingTable.from_record(routing["table"]).n_groups
                      if routing is not None else max(present) + 1)
        missing = set(range(n_expected)) - present
        if missing:
            raise CheckpointCorrupt(
                f"step {step} is missing shard snapshots {sorted(missing)} "
                f"of {n_expected}")
        tokenizer = tokenizer or Utf8Tokenizer()
        featurizer = featurizer or JsonFeaturizer()
        table = (RoutingTable.from_record(routing["table"])
                 if routing is not None else None)
        groups: List[ReplicaGroup] = []
        for g in range(n_expected):
            reps = manager.restore_index_replicas(
                step, name=f"shard{g:02d}", n=replicas,
                tokenizer=tokenizer, featurizer=featurizer)
            if routing is not None:
                floors = routing["groups"][g]
                for idx in reps:
                    idx._next_addr = int(floors["next_addr"])
                    idx._next_seq = int(floors["next_seq"])
            else:
                for idx in reps:
                    # legacy (pre-routing) checkpoints are striped by
                    # construction; a group whose recovered addresses fall
                    # outside its stripe can only come from a rebalanced
                    # family whose routing record was lost — refuse loudly
                    # instead of silently misrouting the moved addresses
                    if idx._next_addr > 0 and \
                            shard_of(idx._next_addr - 1) != g:
                        raise CheckpointCorrupt(
                            f"shard {g} snapshot holds addresses outside "
                            f"its stripe but step {step} has no routing "
                            "record — rebalanced checkpoint missing its "
                            "routing file")
                    idx._next_addr = max(idx._next_addr, g * STRIPE)
            grp = ReplicaGroup(g, reps)
            if routing is not None:
                grp.epoch = table.group_epochs[g]
                grp.retired = bool(routing["groups"][g].get("retired"))
            groups.append(grp)
        return ShardedWarren(tokenizer=tokenizer, featurizer=featurizer,
                             _groups=groups, _table=table)

    # -- internals --------------------------------------------------------- #
    def _require_started(self) -> None:
        if not self._started:
            raise RuntimeError("warren access outside start()/end()")
