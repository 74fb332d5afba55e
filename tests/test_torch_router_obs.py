"""The port's service router (``repro_torch.serving.router``) and its
observability layer (``repro_torch.obs``) against the JAX package's
``repro.serving.router`` and ``repro.obs``, run live on the same seeded call
sequences.

Both packages are the same plain Python and numpy operations, so every
comparison is exact: pick sequences, snapshot dicts and the trace export's
bytes.  Neither module needs torch.
"""

import json

import numpy as np
import pytest

import repro.obs as R
import repro_torch.obs as T
from repro.serving import router as ref_router
from repro_torch.serving import router as port_router

# -- the router ---------------------------------------------------------------------

NAN, INF = float("nan"), float("inf")
WEIGHT_CASES = {
    "seed0": None,
    "seed1": None,
    "seed2": None,
    "all-zero": [0.0, 0.0, 0.0],
    "nan": [120.0, NAN, 40.0],
    "inf": [INF, 5.0],
    "negative": [10.0, -1.0, 30.0],
    "one": [7.5],
    "ties": [50.0, 50.0, 50.0, 50.0],
}


def weights_of(case):
    w = WEIGHT_CASES[case]
    if w is None:
        rng = np.random.default_rng(int(case.removeprefix("seed")))
        w = [float(x) for x in rng.uniform(10.0, 500.0, size=rng.integers(2, 7))]
    return w


def picks(mod, weights, n):
    handles = [mod.InstanceHandle(instance_id=10 + i, size=1 + i % 3, throughput=t)
               for i, t in enumerate(weights)]
    router = mod.WeightedRouter(handles)
    seq = [router.pick().instance_id for _ in range(n)]
    return seq, router.dispatch_counts()


@pytest.mark.parametrize("case", sorted(WEIGHT_CASES))
def test_router_picks_equal_the_reference(case):
    w = weights_of(case)
    assert picks(port_router, w, 2_000) == picks(ref_router, w, 2_000)


@pytest.mark.parametrize("case", ["all-zero", "nan", "inf", "negative"])
def test_router_falls_back_to_round_robin_without_usable_weights(case):
    w = weights_of(case)
    seq, counts = picks(port_router, w, 3 * len(w))
    assert seq == [10 + i for i in range(len(w))] * 3
    assert set(counts.values()) == {3}


@pytest.mark.parametrize("seed", [0, 7, 19])
def test_router_shares_follow_the_weights(seed):
    """The reference's own bound (tests/test_sim.py): over 20,000 picks
    each instance's share is within n / 20000 + 1e-3 of its weight share."""
    rng = np.random.default_rng(seed)
    w = [float(x) for x in rng.uniform(10.0, 500.0, size=rng.integers(2, 7))]
    n = 20_000
    _, counts = picks(port_router, w, n)
    for i, wi in enumerate(w):
        assert abs(counts[10 + i] / n - wi / sum(w)) <= len(w) / n + 1e-3


def test_router_refuses_no_instances():
    for mod in (ref_router, port_router):
        with pytest.raises(ValueError, match="at least one instance"):
            mod.WeightedRouter([])


def test_serving_package_exports_the_router():
    import repro_torch.serving as S

    assert S.WeightedRouter is port_router.WeightedRouter
    assert S.InstanceHandle is port_router.InstanceHandle


# -- metrics ----------------------------------------------------------------------------


def drive_metrics(pkg, seed, reg=None):
    """A seeded call sequence on a registry: counters, gauges, histograms
    (default and custom bounds), samples, metrics born after sampling."""
    rng = np.random.default_rng(seed)
    reg = pkg.MetricsRegistry() if reg is None else reg
    names = ["serving.completed", "pages.used", "reconcile.retried", "queue.depth.critical"]
    totals = {}
    t = 0.0
    for _ in range(60):
        op = int(rng.integers(0, 6))
        name = names[int(rng.integers(0, len(names)))] + f".{int(rng.integers(0, 3))}"
        if op == 0:
            reg.counter("c." + name).inc(float(rng.exponential(2.0)))
        elif op == 1:
            key = "c." + name
            totals[key] = totals.get(key, 0.0) + float(rng.integers(0, 5))
            reg.counter(key).inc_to(max(totals[key], reg.counter(key).value))
        elif op == 2:
            reg.gauge("g." + name).set(float(rng.normal(10.0, 3.0)))
        elif op == 3:
            reg.histogram("h." + name).observe(float(rng.lognormal(0.0, 2.0)))
        elif op == 4:
            reg.histogram("hb." + name, bounds=(0.5, 2.0, 8.0)).observe(
                float(rng.exponential(3.0)))
        else:
            t += float(rng.uniform(0.5, 60.0))
            reg.sample(t)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_metrics_snapshot_equals_the_reference(seed):
    ref, port = drive_metrics(R, seed).snapshot(), drive_metrics(T, seed).snapshot()
    assert port == ref
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["series"]["t_s"]  # the sequence sampled


def test_metrics_refuse_what_the_reference_refuses():
    for pkg in (R, T):
        reg = pkg.MetricsRegistry()
        reg.counter("x").inc(2.0)
        with pytest.raises(ValueError, match="must be >= 0"):
            reg.counter("x").inc(-1.0)
        with pytest.raises(ValueError, match="backwards"):
            reg.counter("x").inc_to(1.0)
        with pytest.raises(ValueError, match="already registered as a counter"):
            reg.gauge("x")


def test_null_registry_and_percentiles_equal_the_reference():
    for pkg in (R, T):
        null = pkg.NullRegistry()
        assert null.enabled is False
        for metric in (null.counter("a"), null.gauge("b"), null.histogram("c")):
            metric.inc(1.0), metric.inc_to(3.0), metric.set(2.0), metric.observe(5.0)
        null.sample(1.0)
        assert null.snapshot() == {}
    rng = np.random.default_rng(4)
    for vals in ([], [0.25], list(rng.lognormal(0.0, 1.0, 101))):
        assert T.percentile_summary(vals, "ttft") == R.percentile_summary(vals, "ttft")


# -- tracing -----------------------------------------------------------------------------


def drive_tracer(pkg, seed):
    """Spans, instants and nested begin/end on a few tracks, in sim time."""
    rng = np.random.default_rng(seed)
    tr = pkg.SpanTracer()
    tracks = ["reoptimize", "actions", "faults", "serving"]
    t = 0.0
    depth = {k: 0 for k in tracks}
    for _ in range(80):
        track = tracks[int(rng.integers(0, len(tracks)))]
        op = int(rng.integers(0, 4))
        t += float(rng.uniform(0.0, 5.0))
        args = {"n": int(rng.integers(0, 9))} if rng.random() < 0.5 else None
        if op == 0:
            tr.span(track, f"span{int(rng.integers(0, 5))}", t, t + float(rng.uniform(0, 3)),
                    args=args)
        elif op == 1:
            tr.instant(track, "mark", t, args=args)
        elif op == 2 and depth[track] < 3:
            tr.begin(track, f"phase{depth[track]}", t, args=args)
            depth[track] += 1
        elif depth[track]:
            tr.end(track, t, args={"closed": True})
            depth[track] -= 1
    for track in tracks:
        for _ in range(depth[track]):
            t += 1.0
            tr.end(track, t)
    return tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_export_bytes_equal_the_reference(seed):
    ref, port = drive_tracer(R, seed), drive_tracer(T, seed)
    assert port.export_json() == ref.export_json()
    assert port.span_summary() == ref.span_summary()
    assert port.span_summary()["events"] > 0


def test_trace_refuses_what_the_reference_refuses():
    for pkg in (R, T):
        tr = pkg.SpanTracer()
        with pytest.raises(ValueError, match="ends before it starts"):
            tr.span("a", "x", 2.0, 1.0)
        with pytest.raises(RuntimeError, match="without begin"):
            tr.end("a", 1.0)
        tr.begin("a", "parent", 5.0)
        with pytest.raises(ValueError, match="before its parent"):
            tr.begin("a", "child", 4.0)
        with pytest.raises(RuntimeError, match="left open"):
            tr.export_json()
        null = pkg.NullTracer()
        null.span("a", "x", 0.0, 1.0), null.begin("a", "y", 0.0), null.end("a", 1.0)
        assert null.export_json() == R.NullTracer().export_json()
        assert null.span_summary() == {}


# -- the flight recorder ------------------------------------------------------------------


def drive_flight(pkg, seed, limit):
    rng = np.random.default_rng(seed)
    fr = pkg.FlightRecorder(limit)
    t = 0.0
    for _ in range(120):
        rid = int(rng.integers(0, 30))
        t += float(rng.exponential(0.5))
        op = int(rng.integers(0, 5))
        if op == 0:
            deadline = [None, INF, t + 3.0][int(rng.integers(0, 3))]
            fr.arrival(rid, f"svc{rid % 3}", t, priority=rid % 3, deadline_s=deadline)
        elif op in (1, 2):
            event = ["queued", "admitted", "preempted", "backoff", "migrated", "crashed",
                     "first_token"][int(rng.integers(0, 7))]
            fr.note(rid, event, t, uid=int(rng.integers(0, 4)), cause="kv_pressure")
        elif op == 3:
            fr.note(rid, "resumed", t)
        else:
            outcome = ["completed", "shed", "deadline_dropped", "retry_dropped",
                       "truncated"][int(rng.integers(0, 5))]
            fr.close(rid, outcome, t, cause="" if outcome == "completed" else "why")
    return fr.snapshot()


@pytest.mark.parametrize("seed,limit", [(0, 256), (1, 8), (2, 0)])
def test_flight_recorder_snapshot_equals_the_reference(seed, limit):
    ref, port = drive_flight(R, seed, limit), drive_flight(T, seed, limit)
    assert port == ref
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    if limit == 8:
        assert port["tracked"] == 8 and port["truncated"] > 0


def test_flight_recorder_refuses_a_negative_limit():
    for pkg in (R, T):
        with pytest.raises(ValueError, match="record_limit"):
            pkg.FlightRecorder(-1)


# -- the bundle ---------------------------------------------------------------------------


def test_observability_bundle_equals_the_reference():
    assert T.__all__ == R.__all__
    off, on = T.Observability.off(), T.Observability.on(record_limit=4)
    assert (off.enabled, off.flight) == (False, None)
    assert isinstance(off.tracer, T.NullTracer) and isinstance(off.metrics, T.NullRegistry)
    assert on.enabled and isinstance(on.tracer, T.SpanTracer)
    assert isinstance(on.metrics, T.MetricsRegistry)
    assert on.flight.record_limit == 4
    ref_on = R.Observability.on(record_limit=4)
    for o in (on, ref_on):
        o.tracer.span("x", "y", 0.0, 1.5)
        drive_metrics(None, 5, reg=o.metrics)
        o.flight.arrival(1, "svc", 0.0)
    assert on.tracer.export_json() == ref_on.tracer.export_json()
    assert on.metrics.snapshot() == ref_on.metrics.snapshot()
    assert on.flight.snapshot() == ref_on.flight.snapshot()
