"""The port's closed-loop simulator (``repro_torch.sim``: the re-optimize
driver, the simulator loop and the scenario matrix) against the JAX
package's ``repro.sim``, both run live in this process on the same cells
and seeds.

Both packages are the same numpy/stdlib operations on the same draws, so
every comparison is exact: ``SimReport.to_json()`` bytes, every
``CellResult`` field (``report_sha256`` included, against the reference's
live run, never a pinned SHA), the observability recorder's Chrome trace
and the matrix document.  No test here needs torch beyond the import guard;
the last one runs ``chip_smoke.py``'s phase 10 on recorded rates.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro  # noqa: E402
import repro.core as R  # noqa: E402
import repro.sim as RS  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.sim as TS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cell_id(cell) -> str:
    return ":".join(str(v) for v in dataclasses.astuple(cell))


def doc(obj) -> str:
    """A result as exact text: ``json.dumps`` writes each float's shortest
    round-trip repr, so equal text is equal values (NaN included)."""
    return json.dumps(obj, sort_keys=True)


def test_exports_equal_the_reference():
    assert TS.__all__ == RS.__all__
    assert repro_torch.__all__ == repro.__all__
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is getattr(TS, name)
    assert sorted(dir(repro_torch)) == sorted(repro_torch.__all__)
    with pytest.raises(AttributeError):
        repro_torch.no_such_name  # noqa: B018


def test_matrix_registries_equal_the_reference():
    assert [dataclasses.asdict(c) for c in TS.default_matrix()] == [
        dataclasses.asdict(c) for c in RS.default_matrix()]
    assert [dataclasses.asdict(c) for c in TS.smoke_matrix()] == [
        dataclasses.asdict(c) for c in RS.smoke_matrix()]
    assert {k: dataclasses.asdict(v) for k, v in TS.SCALES.items()} == {
        k: dataclasses.asdict(v) for k, v in RS.SCALES.items()}
    assert TS.SCHEDULERS == RS.SCHEDULERS and TS.FLUID_SCHEDULERS == RS.FLUID_SCHEDULERS
    for reg in ("TRACE_SHAPES", "SLO_POLICIES", "PRIORITY_MIXES"):
        assert list(getattr(TS, reg)) == list(getattr(RS, reg)), reg
    assert list(TS.FAULT_PROFILES) == list(RS.FAULT_PROFILES)
    services = [f"m{i}" for i in range(4)]
    for name in TS.SLO_POLICIES:
        assert TS.SLO_POLICIES[name](services) == RS.SLO_POLICIES[name](services), name


@pytest.mark.parametrize("index", range(len(RS.smoke_matrix())),
                         ids=[cell_id(c) for c in RS.smoke_matrix()])
def test_smoke_cell_equals_the_reference(index):
    """Every cell of the smoke matrix (fluid, a fault profile, the token
    model with and without the priority mix, a warm start): the report's
    bytes and the whole ``CellResult``."""
    ref_cell, port_cell = RS.smoke_matrix()[index], TS.smoke_matrix()[index]
    ref, ref_rep = RS.run_cell(ref_cell)
    got, rep = TS.run_cell(port_cell)
    assert rep.to_json() == ref_rep.to_json()
    assert doc(got.to_dict()) == doc(ref.to_dict())
    assert got.report_sha256 == ref.report_sha256


def test_observed_cell_equals_the_reference():
    """The flight recorder on the token ``instance_crash``/``mixed`` cell:
    the same report (obs block included), ``SimReport.obs`` and Chrome
    trace-event JSON."""
    cell = ("flash", "greedy", "micro", "uniform", "instance_crash", "token", "mixed")
    ref, ref_rep, ref_trace = RS.run_cell_obs(RS.ScenarioCell(*cell))
    got, rep, trace = TS.run_cell_obs(TS.ScenarioCell(*cell))
    assert rep.obs is not None and doc(rep.obs) == doc(ref_rep.obs)
    assert trace == ref_trace and json.loads(trace)["traceEvents"]
    assert rep.to_json() == ref_rep.to_json()
    assert doc(got.to_dict()) == doc(ref.to_dict())


def test_matrix_document_equals_the_reference():
    cells = [("diurnal", "greedy", "small", "uniform"), ("surge", "energy", "small", "tiered")]
    ref = RS.run_matrix([RS.ScenarioCell(*c) for c in cells], seed=1)
    got = TS.run_matrix([TS.ScenarioCell(*c) for c in cells], seed=1)
    assert len(got["cells"]) == 2
    assert doc(got) == doc(ref)


def day_night_reports(sim, core):
    """A three-hour diurnal trace over four synthetic services, run directly
    and through the control plane under the ``none`` profile."""
    prof = core.SyntheticPaperProfiles(n_models=4, seed=9)
    rng = np.random.default_rng(42)
    peaks = {m: float(rng.lognormal(7.0, 0.5)) for m in prof.services()}
    trace = sim.diurnal_trace(peaks, duration_s=3 * 3600.0, bin_s=60.0, night_frac=0.25,
                              seed=0)
    return [sim.ClusterSimulator(core.a100_rules(), prof, trace,
                                 sim.SimConfig(seed=3, control_plane=cp)).run().to_json()
            for cp in (False, True)]


def test_none_profile_control_plane_gives_the_direct_bytes():
    ref_direct, ref_cp = day_night_reports(RS, R)
    direct, cp = day_night_reports(TS, T)
    assert direct == cp == ref_direct == ref_cp
    assert json.loads(direct)["transitions"]


BAD_CONFIGS = {
    "arrivals": dict(arrivals="bursty"),
    "fault_profile": dict(fault_profile="meteor"),
    "serving_model": dict(serving_model="queueing"),
    "token_needs_poisson": dict(serving_model="token", arrivals="fluid"),
    "priority_needs_token": dict(priority_mix="mixed"),
    "record_limit": dict(obs_record_limit=-1),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_sim_config_refuses_what_the_reference_refuses(case):
    def refusal(pkg):
        kwargs = dict(BAD_CONFIGS[case])
        if "priority_mix" in kwargs:
            kwargs["priority_mix"] = pkg.PRIORITY_MIXES[kwargs["priority_mix"]]
        with pytest.raises(ValueError) as err:
            pkg.SimConfig(**kwargs)
        return str(err.value)

    assert refusal(TS) == refusal(RS)


def test_sim_config_defaults_equal_the_reference():
    assert dataclasses.asdict(TS.SimConfig()) == dataclasses.asdict(RS.SimConfig())
    cfg, ref = TS.SimConfig(fault_profile="gpu_loss"), RS.SimConfig(fault_profile="gpu_loss")
    assert cfg.control_plane and dataclasses.asdict(cfg) == dataclasses.asdict(ref)


# -- chip_smoke.py phase 10 on the CPU ---------------------------------------------------


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_sim_phase_runs_on_the_cpu(capsys):
    """Phase 10 is host code: the closed loop on phase 8's plan from
    recorded observations, under both fault profiles, with its determinism
    and legality gates (a failed gate exits)."""
    from repro_torch.core.arch_bridge import h100_arch_profiles

    cs = chip_smoke()
    archs = list(cs.PLAN_ARCHS)
    seen = []
    make = cs.recording_profiles(T.MeasuredProfile, h100_arch_profiles, seen)
    for arch, rps in zip(archs, [1.1, 1.4, 1.2, 1.1, 1.7, 2.3, 0.9]):
        make(arch).observe(arch, 7, 8, rps)
    plan = cs.plan_mig(T, h100_arch_profiles, seen, 0)
    capsys.readouterr()
    cs.sim_phase(T, TS, plan, 0)
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[sim] ")]
    assert len(lines) == len(cs.SIM_FAULTS)
    for fault, line in zip(cs.SIM_FAULTS, lines):
        assert line.startswith(f"[sim] fault={fault} serving_model=fluid ")
        assert "illegal=0 same_bytes=True" in line
        assert ("availability=" in line) == (fault != "none")
    # the gates' own inputs: the same seed gives the same bytes, and every
    # card of the loop's cluster ends legal under the H100 rules
    runs = [cs.sim_run(T, TS, plan["profile"], plan["day_rates"], plan["night_rates"],
                       "gpu_loss", 0) for _ in range(2)]
    assert runs[0][1].to_json() == runs[1][1].to_json()
    sim, rep = runs[0]
    assert all(T.h100_mig_rules().is_legal_partition(g.partition())
               for g in sim.cluster.gpus.values())
    assert rep.faults and rep.transitions
    assert all(math.isfinite(rep.mean_attainment(s)) for s in rep.services)


def _recorded_plan(cs):
    from repro_torch.core.arch_bridge import h100_arch_profiles

    seen = []
    make = cs.recording_profiles(T.MeasuredProfile, h100_arch_profiles, seen)
    for arch, rps in zip(list(cs.PLAN_ARCHS), [1.1, 1.4, 1.2, 1.1, 1.7, 2.3, 0.9]):
        make(arch).observe(arch, 7, 8, rps)
    return cs.plan_mig(T, h100_arch_profiles, seen, 0)


@pytest.mark.parametrize("fault", ["none", "gpu_loss"])
def test_chip_smoke_sim_phase_moves_with_the_measured_noise(capsys, fault):
    """Phase 10 reads the card through ``throughput_noise``: with sigma 0 its
    reports are the noiseless loop's bytes, with sigma 0.2 other bytes,
    byte-equal across two runs; the [sim] lines print sigma and its source."""
    cs = chip_smoke()
    plan = _recorded_plan(cs)
    args = (T, TS, plan["profile"], plan["day_rates"], plan["night_rates"], fault, 0)
    base = cs.sim_run(*args)[1].to_json()
    assert cs.sim_run(*args, 0.0)[1].to_json() == base
    noisy = [cs.sim_run(*args, 0.2)[1].to_json() for _ in range(2)]
    assert noisy[0] == noisy[1] != base
    capsys.readouterr()
    cs.sim_phase(T, TS, plan, 0, 0.2, "phase6 decode-step device-busy of x/paged")
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[sim] ")]
    assert len(lines) == len(cs.SIM_FAULTS)
    for line in lines:
        assert "throughput_noise=0.2000 noise_source=" in line and "same_bytes=True" in line
        got = line.split("report_sha256=")[1].split()[0]
        assert got != line.split("noiseless_sha256=")[1].split()[0]


def test_tpot_noise_is_the_largest_spread_clipped():
    """Sigma is the largest (p90 - p50) / p50 of a profiled run's decode-step
    device-busy ms (each step's device share of a token's time), clipped
    to [0, 0.5], with the run it came from."""
    cs = chip_smoke()
    flat = [1.0] * 9 + [1.4]  # p50 1.0, p90 1.04
    sigma, source = cs.busy_noise([("a", "paged", [2.0] * 10), ("b", "flat", flat)])
    assert sigma == pytest.approx(0.04) and source.endswith("b/flat")
    assert cs.busy_noise([("a", "paged", [1.0] * 5 + [9.0] * 5)])[0] == 0.5
    assert cs.busy_noise([("a", "paged", [3.0] * 8)])[0] == 0.0


def test_step_busy_counts_each_kernel_in_the_step_it_starts_in():
    """Phase 6's per-step device-busy ms: each kernel's device time goes to
    the traced step whose range holds its start on the card's clock (the
    range's device side), whatever the host side says; the device side of
    the ranges is not a kernel; the share of kernel time the ranges hold;
    the least and largest lag of a device side after its host side."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(kind, name, a, b, us=0.0, note=False):
        return NS(device_type=kind, name=name, time_range=NS(start=a, end=b),
                  self_device_time_total=us, is_user_annotation=note)

    cpu, cuda, label = DeviceType.CPU, DeviceType.CUDA, "chip_smoke_decode_step_"
    # step 1's last kernel (255-265) starts after its host range on the
    # host's clock; on the card's clock it is inside the step
    events = [ev(cpu, label + "1", 200, 250), ev(cpu, label + "0", 0, 100),
              ev(cpu, "aten::mm", 10, 20),
              ev(cuda, label + "1", 210, 265, us=55.0, note=True),
              ev(cuda, label + "0", 12, 90, us=78.0, note=True),
              ev(cuda, "gemm", 12, 40, us=28.0), ev(cuda, "paged_split", 50, 90, us=40.0),
              ev(cuda, "gemm", 210, 250, us=40.0), ev(cuda, "gemm", 255, 265, us=10.0)]
    per_step, cover, lag = cs_step_busy(events)
    assert per_step == [pytest.approx(0.068), pytest.approx(0.05)]
    assert cover == pytest.approx(1.0)
    assert lag == (pytest.approx(0.010), pytest.approx(0.012))
    per_step, cover, _ = cs_step_busy(events + [ev(cuda, "late", 150, 160, us=10.0)])
    assert cover == pytest.approx(118 / 128)
    # a range whose device side is missing is not a step
    no_side = [e for e in events if not (e.is_user_annotation and e.name == label + "1")]
    per_step, cover, _ = cs_step_busy(no_side)
    assert len(per_step) == 1 and cover == pytest.approx(68 / 118)


def cs_step_busy(events):
    return chip_smoke().step_busy(events)
