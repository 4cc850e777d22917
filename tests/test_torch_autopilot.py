"""The port's autopilot (``repro_torch.dist.{autopilot,simharness}`` and
``elastic.autopilot``) against the reference's: every scripted scenario
of the reference's tests gives the same ``Decision.to_record()`` sequence
under both controllers; the seed-11 simulated day and burn day give
equal decision records and p95 trajectories; the hysteresis invariants
hold for any stream (hypothesis, the two controllers equal on each); the
closed loop over each package's real ``ShardedWarren`` makes the same
decisions with the same outcomes and serves the same answers; and
``chip_smoke.py``'s phase ``autopilot`` runs on the CPU at the
benchmark's smoke sizes.  Every comparison is exact.
"""

import json
import math
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro import obs as RO  # noqa: E402
from repro.core import index_document as ref_index_document  # noqa: E402
from repro.dist import autopilot as RA  # noqa: E402
from repro.dist import rebalance as RR  # noqa: E402
from repro.dist import simharness as RS  # noqa: E402
from repro.dist.shard_router import ShardedWarren as RefSharded  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.core import index_document  # noqa: E402
from repro_torch.dist import autopilot as TA  # noqa: E402
from repro_torch.dist import elastic as TE  # noqa: E402
from repro_torch.dist import rebalance as TR  # noqa: E402
from repro_torch.dist import simharness as TS  # noqa: E402
from repro_torch.dist.shard_router import ShardedWarren  # noqa: E402

from test_torch_rebalance import QUERIES, _ingest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (autopilot, simharness, rebalance, obs) of each package
REF, PORT = (RA, RS, RR, RO), (TA, TS, TR, TO)


# --------------------------------------------------------------------- #
# tests/_sim.py's layer, for either package
# --------------------------------------------------------------------- #
def sig(ap, group, docs=100, p95=math.nan, reads=10, writes=0,
        demoted=False, retired=False, seqs=(5, 5), alive=(True, True)):
    return ap.GroupSignal(group=group, docs=docs, p95_ms=p95, reads=reads,
                          writes=writes, demoted=demoted, retired=retired,
                          replica_seqs=tuple(seqs), alive=tuple(alive))


class Recording:
    """tests/_sim.py's RecordingActuator, raising the given package's
    RebalanceAborted; ``explode`` makes ``split`` raise a RuntimeError."""

    def __init__(self, aborted, next_gid=1, fail_kinds=(), fail_budget=None,
                 explode=False):
        self.aborted, self.calls = aborted, []
        self._next_gid = next_gid
        self.fail_kinds, self.fail_budget = set(fail_kinds), fail_budget
        self.explode = explode

    def _maybe_fail(self, kind):
        if kind in self.fail_kinds:
            if self.fail_budget is None:
                raise self.aborted(f"injected {kind} abort")
            if self.fail_budget > 0:
                self.fail_budget -= 1
                raise self.aborted(f"injected {kind} abort")

    def split(self, group):
        self.calls.append(("split", group))
        if self.explode:
            raise RuntimeError("boom")
        self._maybe_fail("split")
        gid = self._next_gid
        self._next_gid += 1
        return gid

    def merge(self, dest, source):
        self.calls.append(("merge", dest, source))
        self._maybe_fail("merge")

    def demote(self, group):
        self.calls.append(("demote", group))
        self._maybe_fail("demote")

    def resync(self, group, replica):
        self.calls.append(("resync", group, replica))
        self._maybe_fail("resync")


def tight_config(ap, **overrides):
    kw = dict(
        split=ap.HotSplitPolicy(p95_hot_ms=50.0, skew_ratio=3.0,
                                min_docs=10, sustain_ticks=3, max_groups=8),
        cold=ap.ColdPolicy(idle_reads=0, demote_after_ticks=3,
                           merge_after_ticks=6, min_groups=2),
        anti_entropy=ap.AntiEntropyPolicy(max_seq_lag=0, sustain_ticks=2),
        hysteresis=ap.Hysteresis(cooldown_ticks=4, min_dwell_ticks=1,
                                 window_ticks=20, max_actions_per_window=8),
        retry=ap.RetryPolicy(base_ticks=1, cap_ticks=8),
        pool=None)
    kw.update(overrides)
    return ap.AutopilotConfig(**kw)


def run_scripted(pkg, ticks, config=None, n_ticks=None, log=None, **act):
    ap, sim, reb, _ = pkg
    clock = sim.SimClock()
    actuator = Recording(reb.RebalanceAborted, next_gid=max(
        s.group for t in ticks for s in t) + 1, **act)
    ctl = ap.Controller(ap.ScriptedSignals(ticks), actuator,
                        config=config or tight_config(ap), clock=clock,
                        decision_log=log)
    for _ in range(n_ticks if n_ticks is not None else len(ticks)):
        ctl.tick()
        clock.advance()
    return ctl, actuator


# The scripted scenarios of tests/test_autopilot.py, for either package:
# name -> fn(ap) -> (ticks, config overrides or None, actuator options)
def _hot(ap):
    hot = [sig(ap, 0, docs=500, p95=80.0, reads=50),
           sig(ap, 1, docs=400, reads=40)]
    return [hot] * 10, None, {}


def _skew(ap):
    skew = [sig(ap, 0, docs=1500), sig(ap, 1, docs=100),
            sig(ap, 2, docs=110)]
    return [skew] * 4, None, {}


def _cold(ap):
    busy = [sig(ap, 0, docs=500, reads=30), sig(ap, 1, docs=300, reads=20)]
    before = [busy + [sig(ap, 2, docs=80, reads=0)]] * 3
    after = [busy + [sig(ap, 2, docs=80, reads=0, demoted=True)]] * 7
    return before + after, None, {}


def _min_groups(ap):
    return [[sig(ap, 0, docs=150, reads=30),
             sig(ap, 1, docs=80, reads=0, demoted=(t >= 3))]
            for t in range(12)], None, {}


def _diverged(ap):
    bad = [sig(ap, 0), sig(ap, 1, seqs=(9, 5))]
    healed = [sig(ap, 0), sig(ap, 1, seqs=(9, 9))]
    return [bad] * 2 + [healed] * 6, None, {}


def _dead(ap):
    dead = [sig(ap, 0, seqs=(9, 3), alive=(True, False))]
    return [dead] * 2 + [[sig(ap, 0, seqs=(9, 9))]] * 4, None, {}


def _repair_first(ap):
    both = [sig(ap, 0, docs=500, p95=80.0, reads=50),
            sig(ap, 1, seqs=(9, 5))]
    return [both] * 6, {"anti_entropy": ap.AntiEntropyPolicy(
        max_seq_lag=0, sustain_ticks=3)}, {}


def _cooldown(ap):
    ticks = ([[sig(ap, 0, docs=500, p95=80.0, reads=50),
               sig(ap, 1, docs=400, reads=40)]] * 3
             + [[sig(ap, 0, docs=250, reads=0), sig(ap, 1, docs=400,
                                                    reads=40),
                 sig(ap, 2, docs=250, reads=0)]] * 17)
    return ticks, {"cold": ap.ColdPolicy(demote_after_ticks=1,
                                         merge_after_ticks=2,
                                         min_groups=1)}, {}


def _window(ap):
    lag = [sig(ap, g, seqs=(9, 5)) for g in range(4)]
    return [lag] * 40, {
        "anti_entropy": ap.AntiEntropyPolicy(max_seq_lag=0,
                                             sustain_ticks=1),
        "hysteresis": ap.Hysteresis(cooldown_ticks=0, min_dwell_ticks=0,
                                    window_ticks=10,
                                    max_actions_per_window=2)}, {}


def _fast(ap):
    return {"hysteresis": ap.Hysteresis(cooldown_ticks=1, min_dwell_ticks=0,
                                        window_ticks=100,
                                        max_actions_per_window=100)}


def _backoff(ap):
    hot = [sig(ap, 0, docs=500, p95=80.0, reads=50),
           sig(ap, 1, docs=400, reads=40)]
    return [hot] * 40, _fast(ap), {"fail_kinds": {"split"}}


def _recovers(ap):
    hot = [sig(ap, 0, docs=500, p95=80.0, reads=50),
           sig(ap, 1, docs=400, reads=40)]
    return [hot] * 20, _fast(ap), {"fail_kinds": {"split"},
                                   "fail_budget": 2}


def _explodes(ap):
    hot = [sig(ap, 0, docs=500, p95=80.0, reads=50),
           sig(ap, 1, docs=400, reads=40)]
    return [hot] * 8, None, {"explode": True}


def _merge_abort(ap):
    busy = [sig(ap, 0, docs=500, reads=30), sig(ap, 1, docs=300, reads=20)]
    return [busy + [sig(ap, 2, docs=80, reads=0, demoted=True)]] * 30, \
        None, {"fail_kinds": {"merge"}, "fail_budget": 3}


SCENARIOS = {"hot_split": _hot, "skew_split": _skew,
             "cold_demote_merge": _cold, "merge_min_groups": _min_groups,
             "resync_diverged": _diverged, "resync_dead": _dead,
             "repair_first": _repair_first, "split_cooldown": _cooldown,
             "window_budget": _window, "backoff_capped": _backoff,
             "backoff_recovers": _recovers, "actuator_error": _explodes,
             "merge_aborts": _merge_abort}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_scenario_gives_the_same_records(name, tmp_path):
    out = []
    for pkg, sub in ((REF, "ref"), (PORT, "port")):
        ticks, over, act = SCENARIOS[name](pkg[0])
        cfg = tight_config(pkg[0], **(over or {}))
        log = str(tmp_path / f"{sub}.jsonl")
        ctl, actuator = run_scripted(pkg, ticks, config=cfg, log=log, **act)
        recs = [d.to_record() for d in ctl.decisions]
        assert [json.loads(line) for line in open(log)] == recs
        out.append((recs, actuator.calls, [d.summary()
                                           for d in ctl.decisions]))
    assert out[0] == out[1]
    assert out[1][0], f"scenario {name} made no decision"


# --------------------------------------------------------------------- #
# the simulated day and the burn day
# --------------------------------------------------------------------- #
def _day(pkg, seed, ticks, controlled=True, burn=False):
    """benchmarks/day_in_the_life.py's simulated and burn-driven days, on
    one package."""
    ap, sim, _, ob = pkg
    clock = sim.SimClock()
    cluster = sim.SimCluster(docs=1200, base_ms=2.0, ms_per_doc=0.05,
                             observe_latency=burn)
    wl = sim.DriftingWorkload(seed=seed, topics=48, reads_per_tick=120,
                              writes_per_tick=8,
                              phase_ticks=max(ticks // 3, 10))
    split = (ap.HotSplitPolicy(p95_hot_ms=math.inf, skew_ratio=math.inf,
                               min_docs=64, sustain_ticks=3, max_groups=8,
                               burn_hot=1.0) if burn else
             ap.HotSplitPolicy(p95_hot_ms=40.0, sustain_ticks=3,
                               min_docs=64, max_groups=8))
    cfg = ap.AutopilotConfig(
        split=split,
        cold=ap.ColdPolicy(demote_after_ticks=15, merge_after_ticks=40,
                           min_groups=2),
        hysteresis=ap.Hysteresis(cooldown_ticks=4, min_dwell_ticks=1,
                                 window_ticks=30, max_actions_per_window=6),
        pool=None)
    signals, burns = cluster, []
    if burn:
        ob.registry().reset()
        monitor = ob.SLOMonitor(
            slos=[ob.SLO(name="serving_p95", kind="latency",
                         objective=0.95, metric="scatter_latency_ms",
                         threshold_ms=40.0)],
            windows=(("short", 5.0), ("long", 20.0)), clock=clock)
        signals = ob.SLOSignalSource(cluster, monitor)
    ctl = ap.Controller(signals, cluster, config=cfg, clock=clock)
    worst = []
    for _ in range(ticks):
        reads, writes = wl.tick_keys()
        cluster.route(reads)
        cluster.ingest(writes)
        if controlled:
            ctl.tick()
        else:
            cluster.collect()
        clock.advance()
        worst.append(max(cluster.base_ms + cluster.ms_per_doc * g.docs
                         for g in cluster.active()))
        if burn:
            burns.append(monitor.burn("serving_p95"))
    if burn:
        ob.registry().reset()
    groups = [(g.lo, g.hi, g.docs, g.demoted) for g in cluster.active()]
    return ([d.to_record() for d in ctl.decisions], worst, repr(burns),
            groups)


@pytest.mark.parametrize("controlled,burn", [(True, False), (False, False),
                                             (True, True)],
                         ids=["controller", "no_policy", "burn"])
def test_seed_11_day_is_equal(controlled, burn):
    ref = _day(REF, 11, 400, controlled, burn)
    port = _day(PORT, 11, 400, controlled, burn)
    assert ref == port
    if controlled:
        assert ref[0], "the day made no decision"


def test_chip_smoke_sim_day_is_the_benchmarks():
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    ctl, _, worst, _ = C.ap_sim_day(11, 150)
    want = _day(PORT, 11, 150)
    assert [d.to_record() for d in ctl.decisions] == want[0]
    assert worst == want[1]


# --------------------------------------------------------------------- #
# hysteresis: any stream
# --------------------------------------------------------------------- #
def _stream_strategy():
    group = st.tuples(st.integers(0, 2000),
                      st.sampled_from([float("nan"), 5.0, 40.0, 80.0,
                                       200.0]),
                      st.integers(0, 50), st.integers(0, 9), st.booleans())
    return st.lists(st.tuples(group, group, group), min_size=10,
                    max_size=40)


@given(_stream_strategy())
@settings(max_examples=30, deadline=None, database=None, derandomize=True)
def test_hysteresis_holds_and_both_controllers_agree(stream):
    out = []
    for pkg in (REF, PORT):
        ap = pkg[0]
        cfg = tight_config(
            ap,
            split=ap.HotSplitPolicy(p95_hot_ms=50.0, skew_ratio=3.0,
                                    min_docs=10, sustain_ticks=2,
                                    max_groups=16),
            cold=ap.ColdPolicy(demote_after_ticks=2, merge_after_ticks=4,
                               min_groups=1),
            anti_entropy=ap.AntiEntropyPolicy(max_seq_lag=0,
                                              sustain_ticks=2),
            hysteresis=ap.Hysteresis(cooldown_ticks=5, min_dwell_ticks=1,
                                     window_ticks=12,
                                     max_actions_per_window=3))
        ticks = [[ap.GroupSignal(group=g, docs=docs, p95_ms=p95,
                                 reads=reads, replica_seqs=(9, seq),
                                 alive=(True, alive))
                  for g, (docs, p95, reads, seq, alive) in enumerate(tick)]
                 for tick in stream]
        ctl, _ = run_scripted(pkg, ticks, config=cfg)
        out.append([d.to_record() for d in ctl.decisions])
    assert out[0] == out[1]
    hys = cfg.hysteresis
    attempts = [d.tick for d in ctl.decisions]
    for t in attempts:
        inside = [u for u in attempts if t - hys.window_ticks < u <= t]
        assert len(inside) <= hys.max_actions_per_window
    assert all(b - a > hys.min_dwell_ticks
               for a, b in zip(attempts, attempts[1:]))

    def touched(d):
        got = {d.group}
        if d.kind in ("split", "merge") and d.target is not None:
            got.add(d.target)
        return got

    for d in (d for d in ctl.decisions if d.outcome == "applied"):
        for later in ctl.decisions:
            if d.tick < later.tick <= d.tick + hys.cooldown_ticks:
                assert not (touched(d) & touched(later))


# --------------------------------------------------------------------- #
# the closed loop on real warrens
# --------------------------------------------------------------------- #
def _real_config(ap):
    return ap.AutopilotConfig(
        split=ap.HotSplitPolicy(p95_hot_ms=0.0, sustain_ticks=2, min_docs=1,
                                max_groups=3),
        cold=ap.ColdPolicy(demote_after_ticks=2, merge_after_ticks=10 ** 6,
                           min_groups=1),
        anti_entropy=ap.AntiEntropyPolicy(max_seq_lag=0, sustain_ticks=2),
        hysteresis=ap.Hysteresis(cooldown_ticks=1, min_dwell_ticks=0,
                                 window_ticks=50, max_actions_per_window=50),
        pool=None)


def _loop(pkg, cls, index_doc, tmp):
    """The reference test's closed loop: hot traffic, a lost replica,
    traffic stopping; the decisions (kind, group, target, outcome, tick)
    and every query's answers after each stage."""
    ap, sim, _, ob = pkg
    warren = cls(n_shards=2, replicas=2, static_dir=tmp)
    _ingest(warren, index_doc, range(80))
    ob.registry().reset()
    clock = sim.SimClock()
    ctl = ap.Controller.for_warren(warren, config=_real_config(ap),
                                   clock=clock)

    def serve():
        with warren:
            for q in QUERIES:
                warren.search(q, k=10)

    def answers():
        with warren:
            return [warren.search(q, k=10) for q in QUERIES]

    stages = []
    for _ in range(3):
        serve()
        ctl.tick()
        clock.advance()
    stages.append(answers())
    warren.groups[0].mark_failed(1)
    for _ in range(4):
        serve()
        ctl.tick()
        clock.advance()
    stages.append(answers())
    for _ in range(4):
        ctl.tick()
        clock.advance()
    stages.append(answers())
    recs = [(d.tick, d.kind, d.group, d.target, d.outcome)
            for d in ctl.decisions]
    state = (warren.n_shards, warren.health(),
             [d is not None for d in warren.demoted()])
    warren.close()
    ob.registry().reset()
    return recs, stages, state


def test_closed_loop_on_real_warrens_is_equal(tmp_path):
    ref = _loop(REF, RefSharded, ref_index_document, str(tmp_path / "r"))
    port = _loop(PORT, ShardedWarren, index_document, str(tmp_path / "p"))
    assert ref == port
    recs, _, (n, health, demoted) = port
    assert {(k, o) for _, k, _, _, o in recs} >= {
        ("split", "applied"), ("resync", "applied"), ("demote", "applied")}
    assert n == 3 and all(all(h) for h in health) and any(demoted)


def test_warren_signals_equal(tmp_path):
    out = []
    for pkg, cls, idx, sub in ((REF, RefSharded, ref_index_document, "r"),
                               (PORT, ShardedWarren, index_document, "p")):
        ap, _, _, ob = pkg
        warren = cls(n_shards=2, replicas=1)
        _ingest(warren, idx, range(40))
        ob.registry().reset()
        src = ap.WarrenSignals(warren)
        seq = [src.collect()]
        with warren:
            for q in QUERIES:
                warren.search(q, k=5)
        seq.append(src.collect())
        seq.append(src.collect())
        out.append([[(s.group, s.docs, s.reads, s.writes, s.p95_ms == s.p95_ms,
                      s.replica_seqs, s.alive) for s in sigs]
                    for sigs in seq])
        warren.close()
        ob.registry().reset()
    assert out[0] == out[1]


def test_elastic_autopilot_starts_and_stops(tmp_path):
    warren = ShardedWarren(n_shards=2, replicas=2, static_dir=str(tmp_path))
    _ingest(warren, index_document, range(40))
    log = str(tmp_path / "decisions.jsonl")
    ctl, stop = TE.autopilot(warren, config=_real_config(TA),
                             interval_s=0.01, decision_log=log)
    try:
        deadline = time.monotonic() + 30
        while ctl.tick_count < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctl.tick_count >= 3
    finally:
        stop.set()
    n = ctl.tick_count
    time.sleep(0.1)
    assert ctl.tick_count <= n + 1          # at most the tick in flight
    warren.close()


# --------------------------------------------------------------------- #
# chip_smoke.py's phase on the CPU, at the benchmark's smoke sizes
# --------------------------------------------------------------------- #
def test_chip_smoke_autopilot_phase_on_cpu(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    out = C.phase_autopilot(torch.device("cpu"), n_docs=200, ticks=150)
    real = out["real"]
    kinds = {(d["kind"], d["outcome"]) for d in real["decisions"]}
    assert {("split", "applied"), ("resync", "applied"),
            ("demote", "applied")} <= kinds
    assert real["groups"] == 3 and all(all(h) for h in real["health"])
    assert real["witness_violations"] == 0 and real["witness_edges"]
    assert all(c["card_vs_host_identical"] == len(C.AP_QUERIES)
               for c in real["parity_checks"])
    assert len(real["parity_checks"]) >= 3 + sum(
        d["outcome"] == "applied" for d in real["decisions"])
    fams = real["scrape_mid_split"]["families"]
    assert "scatter_latency_ms" in fams
    assert "autopilot_ticks_total" in fams
    assert real["tick_trace_spans"][0] == "autopilot.tick"
    sim = out["sim"]
    assert sim["controller_over_start"] <= C.AP_FLATNESS
    assert sim["p95_peak_baseline_ms"] > sim["p95_peak_controller_ms"]
    assert sim["burn_splits"] > 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [ln["phase"] for ln in lines] == [
        "autopilot_sim", "autopilot_decisions", "autopilot_witness",
        "autopilot_real", "autopilot"]
