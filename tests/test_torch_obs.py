"""The port's telemetry plane (``repro_torch.obs``) against the reference's
(``repro.obs``): the same observations give the same histogram reads, the
same Prometheus text byte for byte, the same JSONL records, trace trees,
rotation caps and SLO burn rates; the admin servers answer with the same
keys; the port's hierarchy reader reads ``analysis/lock_hierarchy.toml``
as ``repro.analysis.config.Hierarchy`` does, and both witnesses flag the
same inversions.  Every comparison is exact.
"""

import json
import math
import os
import threading
import urllib.error
import urllib.request

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as R  # noqa: E402
from repro.analysis.config import Hierarchy as RefHierarchy  # noqa: E402
from repro.dist import autopilot as RA  # noqa: E402
from repro.dist import simharness as RS  # noqa: E402
from repro_torch import obs as T  # noqa: E402
from repro_torch.dist import autopilot as TA  # noqa: E402
from repro_torch.dist import simharness as TS  # noqa: E402
from repro_torch.obs.hierarchy import Hierarchy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIERARCHY = os.path.join(ROOT, "analysis", "lock_hierarchy.toml")
PKGS = (R, T)


def _stream(seed: int, n: int) -> np.ndarray:
    """Latencies over the histogram's whole range, zeros, the edges and
    values past them (clamped into the end buckets)."""
    rng = np.random.default_rng(seed)
    v = np.exp(rng.uniform(np.log(1e-4), np.log(1e6), n))
    v[::17] = 0.0
    v[::23] = 1e-3
    v[::29] = 1e5
    return v


# --------------------------------------------------------------------- #
# histograms
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n,lo,hi,per_decade", [
    (0, 1000, 1e-3, 1e5, 20), (1, 37, 1e-3, 1e5, 20), (2, 5000, 0.1, 1e3, 7),
    (3, 1, 1e-3, 1e5, 20)])
def test_histogram_reads_equal(seed, n, lo, hi, per_decade):
    obs_ = _stream(seed, n)
    cut = n // 3
    hs = [pkg.Histogram(lo=lo, hi=hi, per_decade=per_decade)
          for pkg in PKGS]
    prevs = []
    for h in hs:
        for v in obs_[:cut]:
            h.observe(float(v))
        prevs.append(h.bucket_counts())
        for v in obs_[cut:]:
            h.observe(float(v))
    ref, port = hs
    assert prevs[0] == prevs[1]
    assert ref.bucket_counts() == port.bucket_counts()
    assert ref.cumulative_buckets() == port.cumulative_buckets()
    assert json.dumps(ref.snapshot()) == json.dumps(port.snapshot())
    for p in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        a, b = ref.percentile(p), port.percentile(p)
        assert a == b or (math.isnan(a) and math.isnan(b))
        for prev in (None, prevs[0]):
            a = ref.percentile_since(prev, p)
            b = port.percentile_since(prev, p)
            assert a == b or (math.isnan(a) and math.isnan(b))
    for thr in (0.0, 1e-3, 1.0, 40.0, 1e5):
        for prev in (None, prevs[0]):
            assert ref.over_threshold_since(prev, thr) == \
                port.over_threshold_since(prev, thr)


def test_empty_histogram_reads_equal():
    ref, port = R.Histogram(), T.Histogram()
    for p in (0.5, 0.95):
        assert math.isnan(ref.percentile_since(None, p))
        assert math.isnan(port.percentile_since(None, p))
    assert ref.over_threshold_since(None, 1.0) == \
        port.over_threshold_since(None, 1.0) == (0, 0)
    assert json.dumps(ref.snapshot()) == json.dumps(port.snapshot())


# --------------------------------------------------------------------- #
# registry exports
# --------------------------------------------------------------------- #
def _fill(pkg):
    reg = pkg.MetricsRegistry()
    for g in range(3):
        h = reg.histogram("scatter_latency_ms",
                          "per-group fan-out read time", group=g)
        for v in _stream(10 + g, 200):
            h.observe(float(v))
        reg.counter("shard_read_total", "group reads served",
                    group=g).inc(7 * g + 1)
    reg.gauge("slo_burn_rate", "burn", slo="p95", window="short").set(2.5)
    reg.gauge("odd", "NaN and escapes",
              path='a "quoted"\\ value\nline').set(float("nan"))
    reg.gauge("inf_gauge").set(float("inf"))
    reg.counter("plain_total").inc()
    return reg


def test_prometheus_text_equal_byte_for_byte():
    ref, port = _fill(R), _fill(T)
    assert ref.to_prometheus().encode() == port.to_prometheus().encode()
    assert json.dumps(R.sanitize(ref.snapshot()), sort_keys=True) == \
        json.dumps(T.sanitize(port.snapshot()), sort_keys=True)
    a = [(labels, m.snapshot()) for labels, m in ref.series(
        "scatter_latency_ms")]
    b = [(labels, m.snapshot()) for labels, m in port.series(
        "scatter_latency_ms")]
    assert json.dumps(a) == json.dumps(b)
    assert ref.series("absent") == port.series("absent") == []


def test_jsonl_sink_records_equal(tmp_path):
    recs = []
    for pkg, name in ((R, "ref"), (T, "port")):
        sink = pkg.JsonlSink(str(tmp_path / f"{name}.jsonl"))
        reg = _fill(pkg)
        sink.write(reg, extra={"step": 1, "bad": float("nan")})
        reg.counter("plain_total").inc(4)
        sink.write(reg)
        lines = [json.loads(line) for line in
                 open(tmp_path / f"{name}.jsonl")]
        for line in lines:
            assert isinstance(line.pop("ts"), float)
        recs.append(lines)
    assert recs[0] == recs[1]
    assert R.sanitize([1.0, float("-inf"), {"x": float("nan")}]) == \
        T.sanitize([1.0, float("-inf"), {"x": float("nan")}])


def test_disable_and_enable_equal():
    for pkg in PKGS:
        reg = pkg.MetricsRegistry()
        c = reg.counter("c_total")
        reg.disable()
        c.inc(5)
        reg.enable()
        c.inc(2)
        assert c.value == 2


# --------------------------------------------------------------------- #
# traces
# --------------------------------------------------------------------- #
def _strip(tree):
    """A trace tree without its durations (wall time)."""
    return {"name": tree["name"], "labels": tree["labels"],
            "error": tree["error"],
            "children": [_strip(c) for c in tree["children"]]}


def _trace(pkg, tmp_path):
    tr = pkg.Tracer()
    tr.set_slow_dump(0.0, str(tmp_path / "slow.jsonl"), max_bytes=1 << 20)
    with tr.span("serve.batch", size=4):
        for g in range(2):
            with tr.span("scatter", group=g):
                with tr.span("replica_read", group=g, replica=g % 2):
                    pass
        with tr.span("device_score"):
            pass
        with tr.span("merge"):
            pass
    with pytest.raises(ValueError):
        with tr.span("autopilot.tick", tick=0):
            raise ValueError("boom")
    return tr


def test_trace_trees_equal(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, port = _trace(R, tmp_path / "ref"), _trace(T, tmp_path / "port")
    a, b = ref.traces(), port.traces()
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert x.names() == y.names()
        assert _strip(x.tree()) == _strip(y.tree())
        rx, ry = x.to_record(), y.to_record()
        assert rx["root"] == ry["root"]
        assert [(s["name"], s["labels"], s["error"]) for s in rx["spans"]] \
            == [(s["name"], s["labels"], s["error"]) for s in ry["spans"]]
    assert _strip(ref.last_trace("serve.batch").tree()) == \
        _strip(port.last_trace("serve.batch").tree())
    assert port.trace_by_id(b[0].trace_id) is b[0]
    assert ref.n_slow_dumped == port.n_slow_dumped == 2
    dumps = [[json.loads(line)["root"] for line in open(p / "slow.jsonl")]
             for p in (tmp_path / "ref", tmp_path / "port")]
    assert dumps[0] == dumps[1] == ["serve.batch", "autopilot.tick"]


# --------------------------------------------------------------------- #
# rotation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("max_bytes,backups", [(300, 2), (1000, 0),
                                               (64, 3)])
def test_rotating_jsonl_caps_equal(tmp_path, max_bytes, backups):
    out = []
    for pkg, name in ((R, "ref"), (T, "port")):
        d = tmp_path / name
        d.mkdir()
        log = pkg.RotatingJsonl(str(d / "log.jsonl"), max_bytes=max_bytes,
                                backups=backups)
        for i in range(60):
            log.write({"i": i, "pad": "x" * (i % 13)})
        log.write_line('{"raw": true}')
        out.append({os.path.basename(p): open(p).read()
                    for p in log.files()})
    assert out[0] == out[1]
    assert all(len(v) <= max_bytes + 64 for v in out[1].values())


# --------------------------------------------------------------------- #
# SLOs
# --------------------------------------------------------------------- #
def _slo_run(pkg, sim):
    reg = pkg.MetricsRegistry()
    clk = sim.SimClock(step=1.0)
    mon = pkg.SLOMonitor(
        slos=[pkg.SLO(name="p95", kind="latency", objective=0.9,
                      metric="lat_ms", threshold_ms=10.0),
              pkg.SLO(name="commit", kind="ratio", objective=0.99,
                      good_metric="ok_total", bad_metric="fail_total")],
        windows=(("short", 2.0), ("long", 6.0)), reg=reg, clock=clk)
    rng = np.random.default_rng(5)
    burns = [(mon.burn("p95"), mon.burn("commit"))]
    for t in range(30):
        bad = 0.02 if t < 8 else (0.6 if t < 18 else 0.05)
        for g in range(3):
            h = reg.histogram("lat_ms", group=g)
            for v in np.where(rng.random(20) < bad * (g + 1), 50.0,
                              rng.uniform(0.5, 9.0, 20)):
                h.observe(float(v))
        reg.counter("ok_total").inc(int(rng.integers(50, 100)))
        reg.counter("fail_total").inc(int(rng.integers(0, 3 if t < 10
                                                       else 12)))
        mon.tick()
        burns.append((mon.burn("p95"), mon.burn("p95", "short"),
                      mon.burn("commit"), mon.group_burns("p95")))
        clk.advance()
    return burns, mon.report(), reg.to_prometheus()


def test_slo_burn_rates_equal_on_one_stream():
    ref, port = _slo_run(R, RS), _slo_run(T, TS)
    assert repr(ref[0]) == repr(port[0])          # NaN before the first
    assert json.dumps(R.sanitize(ref[1])) == json.dumps(T.sanitize(port[1]))
    assert ref[2] == port[2]
    assert [s.name for s in R.default_slos(40.0)] == \
        [s.name for s in T.default_slos(40.0)]


def test_slo_signal_source_stamps_equal_burns():
    out = []
    for pkg, sim in ((R, RS), (T, TS)):
        clk = sim.SimClock(step=1.0)
        cluster = sim.SimCluster(docs=64, ms_per_doc=1.0,
                                 observe_latency=True)
        pkg.registry().reset()
        mon = pkg.SLOMonitor(
            slos=[pkg.SLO(name="serving_p95", kind="latency",
                          objective=0.95, metric="scatter_latency_ms",
                          threshold_ms=20.0)],
            windows=(("short", 3.0), ("long", 9.0)), clock=clk)
        src = pkg.SLOSignalSource(cluster, mon)
        seq = []
        for _ in range(8):
            cluster.route([0.1] * 20 + [0.7] * 3)
            seq.append([(s.group, s.burn_rate) for s in src.collect()])
            clk.advance()
        out.append(repr(seq))
        pkg.registry().reset()
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="no SLO named"):
        T.SLOSignalSource(TS.SimCluster(),
                          T.SLOMonitor(reg=T.MetricsRegistry()),
                          slo_name="nonsense")


# --------------------------------------------------------------------- #
# the admin server
# --------------------------------------------------------------------- #
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _keys(obj):
    """The key structure of a JSON value: dicts by their keys (recursively),
    lists by their first element."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__


def _admin_answers(pkg, ap, sim, tmp_path, during=None):
    """Each admin endpoint's status and key structure, the server over a
    2 × 2 warren, a controller after three ticks and an SLO monitor;
    ``during`` is called once the server is up, before the requests."""
    from repro.dist.shard_router import ShardedWarren as RefSharded
    from repro_torch.dist.shard_router import ShardedWarren
    cls = RefSharded if pkg is R else ShardedWarren
    warren = cls(n_shards=2, replicas=2, static_dir=str(tmp_path))
    clk = sim.SimClock()
    cluster = sim.SimCluster(docs=40)
    ctl = ap.Controller(cluster, cluster, config=ap.AutopilotConfig(
        split=ap.HotSplitPolicy(skew_ratio=0.5, min_docs=1,
                                sustain_ticks=1), pool=None), clock=clk)
    for _ in range(3):
        cluster.route([0.2] * 5)
        ctl.tick()
        clk.advance()
    mon = pkg.SLOMonitor(reg=pkg.MetricsRegistry(), clock=clk)
    mon.tick()
    out = {}
    with pkg.AdminServer(warren=warren, controller=ctl, slo=mon) as admin:
        if during is not None:
            during()
        tid = pkg.tracer().last_trace("autopilot.tick").trace_id
        for path in ("/healthz", "/readyz", "/metrics.json", "/traces",
                     f"/traces/{tid}", "/routing", "/autopilot/decisions",
                     "/slo", "/tiered/runs", "/tiered/cache", "/nowhere",
                     "/traces/x", "/profile/cpu?seconds=bad"):
            status, body = _get(admin.url(path))
            out[path.replace(str(tid), "<id>")] = (status,
                                                   _keys(json.loads(body)))
        status, text = _get(admin.url("/metrics"))
        out["/metrics"] = (status, sorted(
            line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")))
        status, text = _get(admin.url("/profile/cpu?seconds=0.05"))
        out["/profile/cpu"] = status
    warren.close()
    return out


def _both_admin_answers(tmp_path, port_during=None):
    """(ref, port): each package's admin answers (:func:`_admin_answers`),
    and from ``/metrics.json`` every family that either package's
    process-wide registry held before the calls taken out: ``reset()``
    keeps families, so those are what earlier tests in the process made,
    and only the families the admin calls made are compared."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    for pkg in PKGS:
        pkg.registry().reset()
        pkg.tracer().reset()
    before = set().union(*(pkg.registry().snapshot() for pkg in PKGS))
    ref = _admin_answers(R, RA, RS, tmp_path / "ref")
    port = _admin_answers(T, TA, TS, tmp_path / "port", during=port_during)
    for out in (ref, port):
        status, keys = out["/metrics.json"]
        out["/metrics.json"] = (status, {**keys, "metrics": {
            name: v for name, v in keys["metrics"].items()
            if name not in before}})
    return ref, port


def _same_keys(ref, port):
    assert ref.keys() == port.keys()
    for path in ref:
        if path == "/metrics":
            continue     # each registry also holds its own package's past
        assert ref[path] == port[path], path


def test_admin_endpoints_give_the_same_keys(tmp_path):
    ref, port = _both_admin_answers(tmp_path)
    _same_keys(ref, port)
    assert {"autopilot_ticks_total", "autopilot_tick_ms"} <= \
        set(port["/metrics"][1])


def test_admin_keys_refuse_a_family_of_one_package(tmp_path):
    """A family that only the port's admin call makes (a fresh name, so
    no earlier test can have made it) fails the comparison, whatever ran
    before in the process."""
    def one_more():
        T.registry().counter("admin_probe_only_in_port_total",
                             "made by this test alone").inc()
    ref, port = _both_admin_answers(tmp_path, port_during=one_more)
    assert "admin_probe_only_in_port_total" in port["/metrics.json"][1][
        "metrics"]
    with pytest.raises(AssertionError, match="/metrics.json"):
        _same_keys(ref, port)


# --------------------------------------------------------------------- #
# the lock hierarchy and the witness
# --------------------------------------------------------------------- #
def test_hierarchy_reader_equals_the_analysis_config():
    ref, port = RefHierarchy.load(HIERARCHY), Hierarchy.load(HIERARCHY)
    assert sorted(ref.levels) == sorted(port.levels)
    for name in ref.levels:
        assert ref.rank(name) == port.rank(name)
        assert ref.multi(name) == port.multi(name)
        assert ref.is_hot(name) == port.is_hot(name)
    assert [lv.name for lv in ref.ordered()] == \
        [lv.name for lv in port.ordered()]
    assert ref.blocking_calls == port.blocking_calls
    assert port.rank("nonsense") is None and port.multi("x") == "none"
    assert Hierarchy.load(None).levels == {}


@pytest.mark.parametrize("text,err", [
    ('[locks.a]\nrank = "x" = 1\n', "unsupported value"),
    ("[locks.a]\n= 1\n", "cannot parse"),
    ("[locks.a\n", "bad table header"),
    ("[locks.a]\nrank = [1, 2\n", "unterminated array"),
    ("[locks.a]\nmulti = \"sideways\"\nrank = 1\n", "bad multi")])
def test_hierarchy_reader_refuses_what_the_analysis_refuses(tmp_path, text,
                                                            err):
    path = tmp_path / "h.toml"
    path.write_text(text)
    for cls in (RefHierarchy, Hierarchy):
        with pytest.raises(ValueError, match=err):
            cls.load(str(path))


def _inversions(pkg):
    """Each package's witness over its own ProfiledLocks: a hierarchy
    inversion (wal before group_write), an AB/BA cycle across two
    threads, a descending ascending-class pair and a same-class nesting."""
    w = pkg.LockWitness.from_hierarchy(HIERARCHY)
    pkg.install_witness(w)
    try:
        assert pkg.witness_active() is w
        wal = pkg.ProfiledLock("wal")
        g1 = pkg.ProfiledLock("group_write", order_key=1)
        g2 = pkg.ProfiledLock("group_write", order_key=2)
        a, b = pkg.ProfiledLock("lock_a"), pkg.ProfiledLock("lock_b")
        reb, reb2 = pkg.ProfiledLock("rebalance"), pkg.ProfiledLock(
            "rebalance")
        with wal:
            with g1:
                pass
        with g2:
            with g1:
                pass
        with reb:
            with reb2:
                pass
        with a:
            with b:
                pass

        def other():
            with b:
                with a:
                    pass

        th = threading.Thread(target=other, name="other")
        th.start()
        th.join()
        with pytest.raises(pkg.LockOrderViolation):
            w.check()
        return w.violations(), sorted(w.edges())
    finally:
        pkg.uninstall_witness()


def test_both_witnesses_flag_the_same_inversions():
    ref, port = _inversions(R), _inversions(T)
    assert ref == port
    assert T.witness_active() is None
    kinds = [v.split(":")[0] for v in port[0]]
    assert kinds == ["hierarchy", "ascending-order", "same-class-nesting",
                     "cycle"]


def test_profiled_lock_without_a_witness_and_rlock():
    lock = T.ProfiledLock("tiered_maint", threading.RLock())
    seen = []
    with lock:
        with lock:
            th = threading.Thread(target=lambda: seen.append(lock.locked()))
            th.start()
            th.join()
    assert seen == [True] and not lock.locked()
    assert T.witness_active() is None


# --------------------------------------------------------------------- #
# profiler
# --------------------------------------------------------------------- #
def test_sampling_profiler_and_profile_for():
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(200))

    th = threading.Thread(target=spin, name="spinner", daemon=True)
    th.start()
    try:
        prof = T.SamplingProfiler(interval_s=0.002).start()
        stop.wait(0.1)
        prof.stop()
        text = T.profile_for(0.05, interval_s=0.002)
    finally:
        stop.set()
        th.join()
    assert prof.samples > 0
    assert any(line.startswith("spinner;") for line in
               prof.collapsed().splitlines())
    assert "spinner;" in text
    with pytest.raises(ValueError):
        T.SamplingProfiler(interval_s=0)
