"""The port's simulator parts (``repro_torch.sim``: events, traffic, the
report and the token-level serving model) against the JAX package's
``repro.sim``, run live on the same seeded inputs, and the token model's
§8.3 calibration against the port's own engine.

Both packages are the same numpy/stdlib operations on the same draws, so
every comparison is exact: pop orders, trace arrays with
``np.array_equal``, ``SimReport.to_json()`` bytes, and the token model's
summaries and metrics.  Only the calibration test needs torch.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

import repro.core as R
import repro.obs as RO
import repro.sim as RS
import repro_torch.core as T
import repro_torch.obs as TO
import repro_torch.sim as TS
from repro.serving.router import InstanceHandle as RefHandle
from repro.serving.router import WeightedRouter as RefRouter
from repro.sim import events as ref_events
from repro.sim import servemodel as ref_servemodel
from repro.sim import traffic as ref_traffic
from repro_torch.serving.router import InstanceHandle as PortHandle
from repro_torch.serving.router import WeightedRouter as PortRouter
from repro_torch.sim import events as port_events
from repro_torch.sim import servemodel as port_servemodel
from repro_torch.sim import traffic as port_traffic

SEEDS = [0, 1, 2]


def test_exports_are_the_references():
    assert set(TS.__all__) <= set(RS.__all__)
    for name in TS.__all__:
        assert type(getattr(TS, name)) is type(getattr(RS, name)), name
    assert port_traffic.PRIORITY_CLASSES == ref_traffic.PRIORITY_CLASSES
    assert port_traffic.STANDARD_CLASS == ref_traffic.STANDARD_CLASS
    for name in ("BIN_TICK", "REOPTIMIZE", "TRANSITION_DONE", "FAULT", "RECONCILE", "END"):
        assert getattr(port_events, name) == getattr(ref_events, name)
    assert (port_servemodel.ADMIT_SCAN, port_servemodel._PCTS) == (
        ref_servemodel.ADMIT_SCAN, ref_servemodel._PCTS)


# -- events ------------------------------------------------------------------------------


def drain_events(pkg, seed):
    """Pushes at a few repeated times, some popped as they go; returns the
    early pops, the peek, the drained rest and the empty queue's state."""
    rng = np.random.default_rng(seed)
    q = pkg.EventQueue()
    early = []
    for i in range(200):
        t = float(rng.integers(0, 12)) * 0.5  # many ties
        q.push(t, ["bin_tick", "fault", "reconcile"][i % 3], payload={"i": i})
        if rng.random() < 0.2:
            ev = q.pop()
            early.append((ev.time, ev.seq, ev.kind, ev.payload["i"]))
    peek = (q.peek().time, q.peek().seq, len(q), bool(q))
    rest = [(ev.time, ev.seq, ev.kind, ev.payload["i"]) for ev in q.drain()]
    return early, peek, rest, (q.peek(), len(q), bool(q))


@pytest.mark.parametrize("seed", SEEDS)
def test_event_queue_order_equals_the_reference(seed):
    ref, port = drain_events(RS, seed), drain_events(TS, seed)
    assert port == ref
    rest = port[2]
    # ties pop in push order: the drained events ascend in (time, seq)
    assert rest == sorted(rest) and len({t for t, *_ in rest}) < len(rest)


def test_clock_refuses_to_run_backwards():
    for pkg in (RS, TS):
        clock = pkg.Clock(5.0)
        assert clock.advance_to(7.5) == 7.5
        assert clock.advance_to(7.5 - 1e-12) == 7.5
        with pytest.raises(RuntimeError, match="backwards"):
            clock.advance_to(1.0)


# -- traffic -------------------------------------------------------------------------------

PEAKS = {"svc-b": 120.0, "svc-a": 40.0, "svc-c": 7.5}


def make_traces(pkg, seed):
    return {
        "diurnal": pkg.diurnal_trace(PEAKS, 7200.0, bin_s=60.0, night_frac=0.25,
                                     jitter=0.1, seed=seed),
        "diurnal-smooth": pkg.diurnal_trace(PEAKS, 3600.0, bin_s=90.0, phase_s=600.0,
                                            period_s=1800.0, seed=seed),
        "burst": pkg.poisson_burst_trace(PEAKS, 7200.0, bin_s=60.0, burst_prob=0.1,
                                         seed=seed),
        "flash": pkg.flash_crowd_trace(PEAKS, 3600.0, at_s=600.0 + 100 * seed, bin_s=30.0),
        "surge": pkg.correlated_surge_trace(PEAKS, 7200.0, bin_s=60.0, n_surges=3,
                                            ramp_bins=3, correlation=0.5, seed=seed),
        "replay": pkg.replay_trace({s: np.arange(8) * r for s, r in PEAKS.items()},
                                   bin_s=45.0),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_generators_equal_the_reference(seed):
    ref, port = make_traces(RS, seed), make_traces(TS, seed)
    for shape in ref:
        r, p = ref[shape], port[shape]
        assert (p.bin_s, p.services, p.num_bins, p.duration_s) == (
            r.bin_s, r.services, r.num_bins, r.duration_s), shape
        for svc in r.rates:
            assert np.array_equal(p.rates[svc], r.rates[svc]), (shape, svc)
        for t0, t1 in ((0.0, 600.0), (125.0, 1000.0), (r.duration_s - 70.0, r.duration_s)):
            assert p.mean_rates(t0, t1) == r.mean_rates(t0, t1), (shape, t0, t1)
            assert p.rates_at(t1) == r.rates_at(t1)
            assert p.rate_at("svc-a", t0) == r.rate_at("svc-a", t0)


def test_traffic_refuses_what_the_reference_refuses():
    for pkg in (RS, TS):
        with pytest.raises(ValueError, match="bin width"):
            pkg.Trace(0.0, {"a": np.ones(2)})
        with pytest.raises(ValueError, match="at least one service"):
            pkg.Trace(1.0, {})
        with pytest.raises(ValueError, match="same bins"):
            pkg.Trace(1.0, {"a": np.ones(2), "b": np.ones(3)})
        with pytest.raises(ValueError, match="at least one bin"):
            pkg.diurnal_trace(PEAKS, 10.0, bin_s=60.0)
        with pytest.raises(ValueError, match="night_frac"):
            pkg.diurnal_trace(PEAKS, 600.0, night_frac=1.5)
        with pytest.raises(ValueError, match="correlation"):
            pkg.correlated_surge_trace(PEAKS, 600.0, correlation=2.0)
        with pytest.raises(ValueError, match="one entry per class"):
            pkg.PriorityMix(weights=(1.0, 1.0))
        with pytest.raises(ValueError, match="positive sum"):
            pkg.PriorityMix(weights=(0.0, 0.0, 0.0))
        with pytest.raises(ValueError, match="deadlines must be positive"):
            pkg.PriorityMix(deadline_s=(1.0, 0.0, 2.0))
        with pytest.raises(ValueError, match="not a priority class"):
            pkg.PriorityMix(per_service={"a": "gold"})


@pytest.mark.parametrize("seed", SEEDS)
def test_priority_mix_draws_equal_the_reference(seed):
    out = []
    for pkg in (RS, TS):
        mix = pkg.PriorityMix(weights=(0.1, 0.5, 0.4), per_service={"pinned": "batch"})
        rng = np.random.default_rng(seed)
        out.append([mix.class_of(["pinned", "free", "other"][i % 3], rng) for i in range(300)])
    assert out[0] == out[1]
    assert set(out[1][0::3]) == {2}  # pinned: no draw, always batch


# -- the report ------------------------------------------------------------------------------


def build_report(pkg, seed, faults=True, token=True, priority=True, obs=True):
    """A report from seeded records, with each optional block on or off."""
    rng = np.random.default_rng(seed)
    n = 12
    services = ["svc-a", "svc-b"]
    times = np.arange(n) * 60.0

    def series():
        return rng.uniform(0.0, 100.0, size=n)

    timelines = {}
    for svc in services:
        arrivals, served = series(), series()
        capacity, required = series(), series()
        timelines[svc] = pkg.ServiceTimeline(
            arrivals=arrivals, served=served, capacity=capacity, backlog=series(),
            required=required,
            attainment=np.minimum(1.0, capacity / np.maximum(required, 1e-9)),
            shed=series() if faults else None,
            preempted=series() if token else None, refused=series() if token else None,
            deadline_dropped=series() if priority else None,
            retry_dropped=series() if priority else None)
    transitions = [pkg.TransitionRecord(
        start_s=float(i * 300), end_s=float(i * 300 + rng.uniform(50, 200)),
        serial_seconds=float(rng.uniform(100, 900)),
        parallel_seconds=float(rng.uniform(50, 300)),
        action_counts={"migrate": int(rng.integers(0, 9)), "create": int(rng.integers(0, 9))},
        old_required={s: float(rng.uniform(1, 9)) for s in reversed(services)},
        new_required={s: float(rng.uniform(1, 9)) for s in services},
        gpus_before=int(rng.integers(1, 9)), gpus_after=int(rng.integers(1, 9)),
        transparency_margin={s: float(rng.uniform(-0.5, 5)) for s in services},
        trigger="fault" if faults and i else "demand",
        reconcile={"iterations": i + 1, "retried": i, "converged": True} if faults else None)
        for i in range(3)]
    records = [pkg.FaultRecord(
        time_s=float(rng.uniform(0, 700)), kind=kind, target=int(rng.integers(0, 9)),
        fault_domain=f"rack{i}", killed_instances=int(rng.integers(0, 4)),
        lost_throughput={"svc-b": float(rng.uniform(0, 9)), "svc-a": 1.5},
        spilled=float(rng.integers(0, 30)))
        for i, kind in enumerate(["gpu_failure", "instance_crash", "node_drain"])] if faults else []
    latency = ({s: {"ttft_p50_s": 0.1 * i, "ttft_p99_s": 0.3, "tpot_p50_s": 0.01,
                    "queue_delay_p99_s": 0.2} for i, s in enumerate(services)}
               | {"_totals": {"completed": 9, "preemptions": 2, "refusals": 1}}) if token else None
    prio = ({c: {"goodput": 3, "arrivals": 5, "slo_attainment": 0.6, "deadline_dropped": 1,
                 "retry_dropped": 0, "shed": 1, "retries": 2}
             for c in ("critical", "standard", "batch")} if priority else None)
    return pkg.SimReport(
        seed=seed, bin_s=60.0, times=times, services=services, timelines=timelines,
        transitions=transitions, reoptimize_checks=7, final_gpus=5, faults=records,
        serving_model="token" if token else "fluid", latency=latency, priority=prio,
        obs={"metrics": {"counters": {"b": 1.0, "a": 2.0}}, "spans": {"events": 3}}
        if obs else None)


REPORT_CASES = {
    "all": {}, "fluid": dict(faults=False, token=False, priority=False, obs=False),
    "faults": dict(token=False, priority=False, obs=False),
    "token": dict(faults=False, priority=False, obs=False),
    "token+priority": dict(faults=False, obs=False), "obs": dict(faults=False, token=False),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_report_json_bytes_equal_the_reference(case, seed):
    ref = build_report(RS, seed, **REPORT_CASES[case])
    port = build_report(TS, seed, **REPORT_CASES[case])
    assert port.to_json() == ref.to_json()
    assert port.summary() == ref.summary()
    for svc in ref.services:
        assert port.slo_satisfaction(svc) == ref.slo_satisfaction(svc)
        assert port.mean_attainment(svc) == ref.mean_attainment(svc)
        assert port.served_fraction(svc) == ref.served_fraction(svc)
    assert (port.availability(), port.recovery_time_s(), port.shed_total(),
            port.transparency_margin(), port.transparent) == (
        ref.availability(), ref.recovery_time_s(), ref.shed_total(),
        ref.transparency_margin(), ref.transparent)
    keys = set(json.loads(port.to_json()))
    assert ("faults" in keys) == bool(REPORT_CASES[case].get("faults", True))
    assert ("latency" in keys) == bool(REPORT_CASES[case].get("token", True))


# -- the token-level serving model -------------------------------------------------------------


def token_walk(core, sim, obs, handle, router, seed, resilience):
    """A seeded run of the token model over six one-second bins: arrivals
    routed by weighted routers, a crashed instance, an instance that
    vanishes, sheds, and every observation the model keeps."""
    prof = core.SyntheticPaperProfiles(n_models=3, seed=2)
    services = prof.services()
    mix = sim.PriorityMix(weights=(0.2, 0.5, 0.3), deadline_s=(0.2, 1.0, math.inf)) \
        if resilience else None
    rec = obs.FlightRecorder(48)
    # a small page budget and long outputs, so KV pressure refuses and preempts
    knobs = sim.TokenKnobs(decode_tokens=24, hbm_gb_per_unit=0.006)
    state = sim.TokenServingState(services, prof, lambda s: 200.0, knobs, mix=mix,
                                  recorder=rec)
    live, uid = {}, 0
    for svc in services:
        for size in [s for s in prof.sizes() if prof.feasible(svc, s)][-2:]:
            live[uid] = (svc, size, prof.throughput(svc, size, 200.0))
            uid += 1
    rng = np.random.default_rng(seed)
    out = []
    for k in range(6):
        t0, t1 = float(k), float(k + 1)
        if k == 3:  # an instance vanishes mid-run (a transition deleted it)
            live.pop(min(live))
        state.sync_instances(live, lambda u: 1.0 + 0.05 * (u % 3), t0)
        for svc in services:
            members = sorted(u for u, v in live.items() if v[0] == svc)
            r = router([handle(instance_id=u, size=live[u][1], throughput=live[u][2])
                        for u in members]) if members else None
            n = int(rng.poisson(300.0))
            reqs = [state.make_request(svc, t0 + float(a), rng)
                    for a in np.sort(rng.uniform(0.0, 1.0, size=n))]
            shed = reqs[: n // 10] if k == 4 else []
            for req in shed:
                state.record_shed(req)
            state.dispatch(svc, members, (lambda r=r: r.pick().instance_id),
                           reqs[len(shed):])
        if k == 2:  # a process dies mid-bin, its in-flight requests spill
            state.serve_bin(t0 + 0.5)
            out.append(("crash", state.crash_instance(sorted(state.instances)[1], t0 + 0.5)))
        state.serve_bin(t1)
        out.append([(svc, state.completed_in(svc, t0, t1), state.in_system(svc))
                    for svc in services])
    m = dataclasses.asdict(dataclasses.replace(state.metrics, recorder=None))
    return out, state.latency_summary(), state.priority_summary(), m, rec.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("resilience", [False, True], ids=["no-mix", "mix"])
def test_token_serving_equals_the_reference(resilience, seed):
    ref = token_walk(R, RS, RO, RefHandle, RefRouter, seed, resilience)
    port = token_walk(T, TS, TO, PortHandle, PortRouter, seed, resilience)
    assert port[0] == ref[0]  # per-bin completions and in-system counts
    assert port[1] == ref[1]  # latency summary
    assert port[2] == ref[2]  # priority summary
    assert port[3] == ref[3]  # every observation stream and counter
    assert port[4] == ref[4]  # the flight recorder
    totals = port[1]["_totals"]
    assert totals["completed"] > 0 and totals["preemptions"] > 0  # KV pressure bites
    assert totals["refusals"] > 0
    assert port[0][2][0] == "crash" and port[0][2][1] > 0


def test_token_knobs_equal_the_reference():
    for kw in ({}, dict(profiled_decode_tokens=64, max_len=2048, page_size=16, kv_heads=8,
                        head_dim=128, n_layers=36, hbm_gb_per_unit=0.4)):
        ref, port = RS.TokenKnobs(**kw), TS.TokenKnobs(**kw)
        assert [port.num_pages(s) for s in (1, 2, 3, 4, 7)] == [
            ref.num_pages(s) for s in (1, 2, 3, 4, 7)]
        assert (port.step_decode_tokens, port.max_pages_per_req) == (
            ref.step_decode_tokens, ref.max_pages_per_req)
        assert [port.retry_backoff_s(k) for k in range(6)] == [
            ref.retry_backoff_s(k) for k in range(6)]


# -- calibration against the port's engine (§8.3) ----------------------------------------------


def test_token_model_calibrates_to_measured_engine_throughput():
    """The reference's calibration test on the port's engine: run the
    engine on the CPU, feed its measured throughput into a MeasuredProfile
    (ewma 1.0: corrected == measured), build the token model on that
    profile with the engine's geometry, and hold its request throughput
    within 0.35 of the engine's."""
    torch = pytest.importorskip("torch")
    torch.set_num_threads(2)
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import Engine, Request, run_closed_loop

    BATCH, MAX_LEN, PROMPT, DECODE = 4, 64, 6, 8
    cfg = get_smoke_config("qwen3-8b")
    m = Model(cfg)
    params = m.init(0, device="cpu")
    eng = Engine(m, params, batch=BATCH, max_len=MAX_LEN, kv_backend="paged",
                 page_size=4, num_pages=8 * BATCH)
    rng = np.random.default_rng(0)

    def make_reqs(n, rid0=0):
        return [Request(rid=rid0 + i,
                        prompt=rng.integers(1, cfg.vocab_size, size=PROMPT).astype(np.int32),
                        max_new_tokens=DECODE)
                for i in range(n)]

    run_closed_loop(eng, make_reqs(BATCH))  # warm up
    base = T.SyntheticPaperProfiles(n_models=2, seed=2)
    svc = sorted(base.services())[0]
    measured = T.MeasuredProfile(base, ewma=1.0)
    N = 24
    stats = run_closed_loop(eng, make_reqs(N, rid0=100), measured=measured, service=svc,
                            size=1)
    assert stats.served == N
    assert measured.correction(svc, 1) != 1.0  # the observation landed

    # page pool oversized on both sides so KV pressure plays no role here
    knobs = TS.TokenKnobs(prompt_tokens=PROMPT, decode_tokens=DECODE,
                          profiled_decode_tokens=DECODE, max_len=MAX_LEN, page_size=4,
                          hbm_gb_per_unit=1.0, prefill_chunk=PROMPT)
    state = TS.TokenServingState([svc], measured, lambda s: 1e9, knobs)
    inst = TS.InstanceModel(0, svc, 1, slots=BATCH, knobs=knobs,
                            step_time_s=state.step_time_for(svc, 1), now=0.0)
    metrics = port_servemodel.TokenMetrics([svc])
    for i in range(N):
        inst.queue.append(TS.TokenRequest(i, svc, 0.0, PROMPT, DECODE))
    inst.run_until(1e9, metrics)
    assert len(metrics.completed_at[svc]) == N
    model_tput = N / max(metrics.completed_at[svc])
    rel = abs(model_tput - stats.throughput) / stats.throughput
    assert rel <= 0.35, (f"token model {model_tput:.2f} req/s vs engine "
                         f"{stats.throughput:.2f} req/s (rel err {rel:.2f})")
