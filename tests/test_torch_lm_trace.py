"""Spans and counters in the port's LM path, and their attribution to a
device trace (``repro_torch.obs.timeline``), on the CPU.

The span trees of one ``decode_step`` and one ``prefill`` at tiny dense
and MoE configs; tracing off records nothing and leaves the logits bit
for bit; the MoE counters against a count made here from
``moe_dispatch``'s ``keep`` and ``idx_buf``; the attribution of device
operations and idle gaps on synthetic profiler events.
"""

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import lm_family as TF  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.obs import timeline  # noqa: E402
from repro_torch.obs.trace import now_ns  # noqa: E402

ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b"]


@contextlib.contextmanager
def telemetry(on: bool):
    """The process's tracer and registry on (or off) with an empty ring,
    restored after."""
    was = (obs.tracer().enabled, obs.registry().enabled)
    (obs.enable if on else obs.disable)()
    obs.tracer().reset()
    try:
        yield obs.tracer()
    finally:
        obs.tracer().reset()
        obs.tracer().enabled, obs.registry().enabled = was


def _model(arch, seed=0):
    cfg = TF._smoke(TF.CONFIGS[arch])
    return TT.init_params(cfg, torch.Generator().manual_seed(seed))


def _decode(model, seed=1):
    """One decode step of 3 rows over 5 cached positions."""
    cfg = model.cfg
    cache = TT.init_cache(cfg, 3, 16)
    g = torch.Generator().manual_seed(seed)
    cache["k"].normal_(generator=g)
    cache["v"].normal_(generator=g)
    cache["length"].fill_(5)
    tokens = torch.randint(0, cfg.vocab, (3,), generator=g)
    return TT.decode_step(model, cache, tokens)[0]


def _prefill(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    return TT.prefill(model, torch.randint(0, model.cfg.vocab, (2, 12),
                                           generator=g))


def _check_tree(trace, root, children):
    """The trace's spans: ``root`` once, at the root; each other span's
    interval inside its parent's; the count of each name."""
    spans = trace.spans
    by_id = {s.span_id: s for s in spans}
    assert trace.root.name == root and trace.root.parent_id is None
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s is not trace.root:
            p = by_id[s.parent_id]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    names = [s.name for s in spans]
    assert {n: names.count(n) for n in set(names)} == {root: 1, **children}
    return by_id


def _ffn(cfg):
    if cfg.moe is None:
        return {"lm.mlp": cfg.n_layers}
    return {"lm.moe": cfg.n_layers, "lm.moe.dispatch": cfg.n_layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_span_tree(arch):
    model = _model(arch)
    n = model.cfg.n_layers
    with telemetry(True) as tr:
        _decode(model)
        traces = tr.traces()
    assert len(traces) == 1
    by_id = _check_tree(traces[0], "lm.decode_step",
                        {"lm.attention": n, "lm.gqa_decode": n,
                         **_ffn(model.cfg)})
    parent = {s.name: by_id[s.parent_id].name for s in traces[0].spans
              if s.parent_id is not None}
    assert parent == {"lm.attention": "lm.decode_step",
                      "lm.gqa_decode": "lm.attention",
                      **{k: "lm.decode_step" for k in ("lm.mlp", "lm.moe")
                         if k in parent},
                      **({"lm.moe.dispatch": "lm.moe"}
                         if model.cfg.moe else {})}
    # a layer's attention ends before its FFN starts
    layer = sorted((s for s in traces[0].spans
                    if by_id.get(s.parent_id) is traces[0].root),
                   key=lambda s: s.start_ns)
    assert [s.name for s in layer] == \
        ["lm.attention", "lm.moe" if model.cfg.moe else "lm.mlp"] * n
    assert all(a.end_ns <= b.start_ns for a, b in zip(layer, layer[1:]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_span_tree(arch):
    model = _model(arch)
    with telemetry(True) as tr:
        _prefill(model)
        traces = tr.traces()
    assert len(traces) == 1
    _check_tree(traces[0], "lm.prefill",
                {"lm.attention": model.cfg.n_layers, **_ffn(model.cfg)})
    rec = traces[0].to_record()
    root = traces[0].root
    assert rec["duration_ms"] == (root.end_ns - root.start_ns) / 1e6
    assert rec["spans"][0]["start_ts"] == pytest.approx(
        root.start_ts, abs=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_off_records_nothing_and_keeps_the_logits(arch):
    model = _model(arch)
    with telemetry(True) as tr:
        on = (_decode(model), _prefill(model))
        assert len(tr.traces()) == 2
    with telemetry(False) as tr:
        off = (_decode(model), _prefill(model))
        assert tr.traces() == []
    for a, b in zip(on, off):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# MoE counters
# --------------------------------------------------------------------- #
def _layer(e, k, factor, t, seed, d=16, f=8):
    """A one-layer MoE config at ``factor`` and a layer whose router
    favours later experts (so a capacity below E / K binds)."""
    cfg = TT.TransformerConfig(
        name="moe-count", n_layers=1, d_model=d, n_heads=1, n_kv_heads=1,
        d_ff=f, vocab=8, dtype="float32",
        moe=TT.MoEConfig(n_experts=e, top_k=k, d_expert_ff=f,
                         capacity_factor=factor))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[:, -1] = 1.0
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    router[-1] = np.linspace(0.0, 3.0, e)
    lp = {"router": router}
    for n, shape in {"e_gate": (e, d, f), "e_up": (e, d, f),
                     "e_down": (e, f, d)}.items():
        lp[n] = rng.standard_normal(shape).astype(np.float32)
    return cfg, torch.from_numpy(x), {n: torch.from_numpy(w)
                                      for n, w in lp.items()}


def _counted(probs, m):
    """The four counts from ``moe_dispatch``'s outputs, by loops."""
    _, top_e, pos, keep, idx_buf = TT.moe_dispatch(probs, m)
    t, k = keep.shape
    kept = lost = 0
    for i in range(t):
        for j in range(k):
            if keep[i, j]:
                kept += 1
                lost += int(idx_buf[top_e[i, j], pos[i, j]]) != i
    return {"kept": kept, "dropped": t * k - kept, "lost": lost,
            "slots": idx_buf.numel()}


COUNTERS = {"kept": "lm_moe_assignments_kept_total",
            "dropped": "lm_moe_assignments_dropped_total",
            "lost": "lm_moe_kept_lost_total",
            "slots": "lm_moe_slots_total"}


@pytest.mark.parametrize("factor,drops", [(1.0, True), (4.0, False)],
                         ids=["drops", "dropless"])
def test_moe_counters_match_the_dispatch(factor, drops):
    """At capacity factor 1.0 assignments drop and a kept one is lost to
    a dropped winner of its slot (fault (t)); at E / K nothing drops and
    the slots filled are T·K of E·C."""
    e, k, t = 8, 2, 96
    cfg, x, lp = _layer(e, k, factor, t, seed=2)
    probs = torch.softmax(x.float() @ lp["router"].float(), dim=-1)
    want = _counted(probs, cfg.moe)
    c = TT.capacity(t, cfg.moe)
    assert want["slots"] == e * c
    if drops:
        assert want["dropped"] > 0 and want["lost"] > 0
    else:
        assert want == {"kept": t * k, "dropped": 0, "lost": 0,
                        "slots": e * c}
        assert want["kept"] / want["slots"] == t * k / (e * c)
    reg = obs.registry()
    with telemetry(True):
        TT.MOE_COUNTS.flush()                 # other tests' sums
        before = {n: reg.counter(m).value for n, m in COUNTERS.items()}
        TT.moe_block(x, lp, cfg)
        TT.moe_block(x, lp, cfg)
        got = TT.MOE_COUNTS.flush()
        after = {n: reg.counter(m).value for n, m in COUNTERS.items()}
    assert got == {n: 2 * v for n, v in want.items()}
    assert {n: after[n] - before[n] for n in COUNTERS} == got
    assert TT.MOE_COUNTS.flush() == {n: 0 for n in COUNTERS}


def test_moe_counters_off_with_the_registry():
    cfg, x, lp = _layer(8, 2, 1.0, 32, seed=3)
    with telemetry(True):
        TT.MOE_COUNTS.flush()
    with telemetry(False):
        TT.moe_block(x, lp, cfg)
    with telemetry(True):
        assert TT.MOE_COUNTS.flush() == {n: 0 for n in COUNTERS}


def _exported(reg) -> dict:
    snap = reg.snapshot()
    return {n: snap[m]["series"][0]["value"] if m in snap else 0
            for n, m in COUNTERS.items()}


def test_moe_counters_reach_the_registry_s_exports():
    """The registry flushes the counters before each export: a snapshot
    and the Prometheus text carry every call up to the read, and a read
    with no MoE call since adds nothing."""
    cfg, x, lp = _layer(8, 2, 1.0, 32, seed=4)
    probs = torch.softmax(x.float() @ lp["router"].float(), dim=-1)
    want = _counted(probs, cfg.moe)
    reg = obs.registry()
    with telemetry(True):
        before = _exported(reg)
        TT.moe_block(x, lp, cfg)
        mid = _exported(reg)
        TT.moe_block(x, lp, cfg)
        text = reg.to_prometheus()
        after = _exported(reg)
        assert _exported(reg) == after
    assert {n: mid[n] - before[n] for n in COUNTERS} == want
    assert {n: after[n] - before[n] for n in COUNTERS} == {
        n: 2 * v for n, v in want.items()}
    assert f"lm_moe_slots_total {after['slots']}" in text


def test_dry_run_steps_with_telemetry_off():
    """``launch.dryrun.obs_off`` turns the tracer and the registry off
    inside and puts back each one's state after, also on an error."""
    from repro_torch.launch import dryrun
    was = (obs.tracer().enabled, obs.registry().enabled)
    try:
        for state in ((True, True), (True, False), (False, True)):
            obs.tracer().enabled, obs.registry().enabled = state
            with pytest.raises(KeyError):
                with dryrun.obs_off():
                    assert not obs.tracer().enabled
                    assert not obs.registry().enabled
                    raise KeyError
            assert (obs.tracer().enabled, obs.registry().enabled) == state
    finally:
        obs.tracer().enabled, obs.registry().enabled = was


# --------------------------------------------------------------------- #
# attribution to a device trace
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class S:
    name: str
    span_id: int
    parent_id: Optional[int]
    start_ns: int
    end_ns: int


SHIFT = 5_000          # the profiler's clock reads the span clock + 5,000
# root [100, 1000) > attention [200, 500) > gqa [300, 400); mlp [600, 900)
SPANS = [S("lm.decode_step", 1, None, 100, 1000),
         S("lm.attention", 2, 1, 200, 500),
         S("lm.gqa_decode", 3, 2, 300, 400),
         S("lm.mlp", 4, 1, 600, 900)]


def _call(corr, t, name="cudaLaunchKernel"):
    return timeline.Event(corr, name, t + SHIFT, t + SHIFT + 5, False)


def _op(corr, a, b, name="k"):
    return timeline.Event(corr, name, a + SHIFT, b + SHIFT, True)


def _trace_events():
    calls = [_call(1, 210), _call(2, 310), _call(3, 550), _call(4, 650),
             _call(5, 1100), _call(6, 320, "cudaMemcpyAsync"),
             _call(7, 700),                          # no device op
             _call(8, 720, "cudaStreamIsCapturing")]
    # the ops in another order than their calls, one op of call 4 twice
    # (two kernels of one launch), one op whose call is not in the trace;
    # op 2 starts as its call does (the fastest launch: no skew)
    ops = [_op(5, 1150, 1160), _op(4, 680, 700), _op(4, 700, 710),
           _op(3, 600, 640), _op(2, 310, 380), _op(1, 240, 250),
           _op(6, 400, 450), _op(99, 1170, 1180)]
    return calls, ops


def test_attribute_by_correlation_nesting_and_outside():
    calls, ops = _trace_events()
    out = timeline.attribute(calls + ops, SPANS, (SHIFT, 0))
    ns = 1e-9
    assert out["device_s"] == pytest.approx({
        "lm.decode_step/lm.attention": 10 * ns,
        "lm.decode_step/lm.attention/lm.gqa_decode": (70 + 50) * ns,
        "lm.decode_step": 40 * ns,
        "lm.decode_step/lm.mlp": 30 * ns,
        "outside": 10 * ns, "unmatched": 10 * ns})
    assert out["launches"] == {
        "lm.decode_step/lm.attention": 1,
        "lm.decode_step/lm.attention/lm.gqa_decode": 2,
        "lm.decode_step": 1, "lm.decode_step/lm.mlp": 1, "outside": 1}
    assert out["ops_unmatched"] == 1 and out["calls_without_op"] == 1
    # idle gaps by the span open at each gap's middle (the window opens
    # at call 1's start): [210, 240) and [250, 310) in attention, [380,
    # 400) in gqa, [450, 600) and [710, 1150) in the root alone, [640,
    # 680) in mlp, [1160, 1170) outside
    assert out["idle_s"] == pytest.approx({
        "lm.decode_step/lm.attention": (30 + 60) * ns,
        "lm.decode_step/lm.attention/lm.gqa_decode": 20 * ns,
        "lm.decode_step": (150 + 440) * ns,
        "lm.decode_step/lm.mlp": 40 * ns,
        "outside": 10 * ns})
    assert out["window_s"] == pytest.approx((1180 - 210) * ns)
    assert out["busy_s"] + sum(out["idle_s"].values()) == \
        pytest.approx(out["window_s"])
    assert out["device_skew_ns"] == 0


def test_attribute_takes_out_the_device_clock_s_skew():
    """The device's timestamps 300 ns behind the host's: the same
    attribution, the skew read from the fastest launch."""
    calls, ops = _trace_events()
    want = timeline.attribute(calls + ops, SPANS, (SHIFT, 0))
    late = [o._replace(start_ns=o.start_ns - 300, end_ns=o.end_ns - 300)
            for o in ops]
    got = timeline.attribute(calls + late, SPANS, (SHIFT, 0))
    assert got.pop("device_skew_ns") == -300
    want.pop("device_skew_ns")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (pytest.approx(v) if isinstance(v, dict) else v)


def test_clock_offset_from_the_mark():
    """The offset from the mark's call that its readings hold tightest;
    the mark's calls are the first ones, in order."""
    sync = "cudaDeviceSynchronize"
    events = [timeline.Event(1, sync, 9_000, 9_040, False),
              timeline.Event(2, sync, 9_100, 9_120, False),
              timeline.Event(3, sync, 20_000, 20_010, False)]
    # span clock: the first call read 3,000-4,990 (slack 1,950), the
    # second 4,095-4,130 (slack 15)
    mark = [(3_000, 4_990), (4_095, 4_130)]
    offset, err = timeline.clock_offset_ns(events, mark)
    assert offset == (9_100 + 9_120 - 4_095 - 4_130) // 2
    assert err == 15 // 2 + 1
    assert timeline.clock_offset_ns(events, mark[:1]) == (
        (9_000 + 9_040 - 3_000 - 4_990) // 2, 1_950 // 2 + 1)
    with pytest.raises(ValueError, match="outlasts"):
        timeline.clock_offset_ns(events, [(4_000, 4_010)])
    with pytest.raises(ValueError, match="holds 0 cudaDeviceSynchronize"):
        timeline.clock_offset_ns(events[:0], mark)


def test_from_profiler_reads_ids_names_and_times():
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    @dataclasses.dataclass
    class Range:
        start: float
        end: float

    @dataclasses.dataclass
    class Fe:
        id: int
        name: str
        time_range: Range
        device_type: object

    got = timeline.from_profiler([Fe(7, "k", Range(1.5, 2.25), cuda),
                                  Fe(7, "cudaLaunchKernel", Range(1.0, 1.2),
                                     cpu)])
    assert got == [timeline.Event(7, "k", 1500, 2250, True),
                   timeline.Event(7, "cudaLaunchKernel", 1000, 1200, False)]


def test_span_clock_is_the_tracer_s():
    tr = obs.Tracer()
    t0 = now_ns()
    with tr.span("lm.prefill"):
        pass
    t1 = now_ns()
    span = tr.traces()[0].root
    assert t0 <= span.start_ns <= span.end_ns <= t1
    assert span.duration_s == (span.end_ns - span.start_ns) / 1e9
