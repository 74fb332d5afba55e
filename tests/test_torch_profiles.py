"""The port's profile layer (paper §5's PerfProfile, §8.3's MeasuredProfile,
the roofline over architectures) against the JAX package's numpy-only
``repro.core``, and the H100 MIG chip that replaces its TPU chip."""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core.arch_bridge import arch_perf_specs as ref_arch_perf_specs  # noqa: E402
from repro.core.arch_bridge import tpu_arch_profiles  # noqa: E402
from repro.core.online_profiles import MeasuredProfile as RefMeasuredProfile  # noqa: E402
from repro.core.profiles import TpuChip  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core.arch_bridge import arch_perf_specs, h100_arch_profiles  # noqa: E402
from repro_torch.core.online_profiles import MeasuredProfile  # noqa: E402
from repro_torch.core.profiles import BATCH_CANDIDATES, RooflineProfiles  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TPU_SIZES = (16, 32, 64, 128, 256)  # the reference's pod-slice sizes
SLOS_MS = (5.0, 20.0, 100.0, 1e9)


class LinearChip:
    """Per-unit constants times the instance size: the reference's
    roofline, which scales one TPU chip's figures by the slice's chips."""

    def __init__(self, unit: TpuChip):
        self.unit = unit

    def flops(self, size):
        return size * self.unit.flops

    def hbm_bw(self, size):
        return size * self.unit.hbm_bw

    def hbm_bytes(self, size):
        return size * self.unit.hbm_bytes


def linear_profiles():
    return RooflineProfiles(arch_perf_specs(), sizes=TPU_SIZES, chip=LinearChip(TpuChip()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_perf_specs_equal_the_reference(arch):
    for context in (4096, 512):
        (mine,), (ref,) = arch_perf_specs([arch], context), ref_arch_perf_specs([arch], context)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_arch_perf_specs_default_to_the_ports_registry():
    assert [s.name for s in arch_perf_specs()] == list(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_linear_chip_reproduces_the_reference_roofline(arch):
    mine, ref = linear_profiles(), tpu_arch_profiles(list(ARCH_IDS))
    assert tuple(mine.sizes()) == tuple(ref.sizes())
    for size in TPU_SIZES:
        for b in BATCH_CANDIDATES:
            got, want = mine.latency_ms(arch, size, b), ref.latency_ms(arch, size, b)
            if math.isinf(want):
                assert got == math.inf, (size, b)
            else:
                assert got == pytest.approx(want, rel=1e-12), (size, b)
        for slo in SLOS_MS:
            assert mine.best_batch(arch, size, slo) == ref.best_batch(arch, size, slo)
            assert mine.throughput(arch, size, slo) == pytest.approx(
                ref.throughput(arch, size, slo), rel=1e-12)
    assert mine.min_size(arch) == ref.min_size(arch)
    for slo in SLOS_MS:
        assert mine.classify(arch, slo) == ref.classify(arch, slo)


@pytest.mark.parametrize("ewma", [0.3, 0.5])
def test_measured_profile_corrections_equal_the_reference(ewma):
    mine = MeasuredProfile(linear_profiles(), ewma=ewma)
    ref = RefMeasuredProfile(tpu_arch_profiles(list(ARCH_IDS)), ewma=ewma)
    obs = [("qwen3-8b", 16, 8, 120.0), ("qwen3-8b", 16, 4, 95.5), ("zamba2-1.2b", 32, 2, 7.25),
           ("qwen3-8b", 16, 8, 0.0), ("granite-20b", 64, 16, 310.0), ("qwen3-8b", 32, 1, 2.5),
           ("llama3-405b", 16, 128, 40.0), ("llama3-405b", 256, 1, 1.5)]
    for model, size, batch, tput in obs:
        mine.observe(model, size, batch, tput)
        ref.observe(model, size, batch, tput)
        for m, s in {(o[0], o[1]) for o in obs}:
            assert mine.correction(m, s) == pytest.approx(ref.correction(m, s), rel=1e-12)
            for b in (1, 8):
                got, want = mine.latency_ms(m, s, b), ref.latency_ms(m, s, b)
                assert got == want or got == pytest.approx(want, rel=1e-12)
    assert mine.correction("mamba2-370m", 16) == 1.0  # never observed


def test_measured_profile_ignores_what_the_base_cannot_run():
    """llama3-405b fits no H100 instance: observing it leaves the
    correction at 1, as the reference's does for an infinite latency."""
    p = MeasuredProfile(h100_arch_profiles())
    assert p.predicted("llama3-405b", 7, 8) == 0.0
    p.observe("llama3-405b", 7, 8, 3.0)
    assert p.correction("llama3-405b", 7) == 1.0
    p.observe("qwen3-8b", 7, 8, 3.0)
    ratio = 3.0 / p.predicted("qwen3-8b", 7, 8)
    assert p.correction("qwen3-8b", 7) == pytest.approx(0.7 + 0.3 * ratio, rel=1e-12)


def test_mig_chip_whole_card_and_memory_slices():
    chip = hw.H100MigChip()
    assert (chip.flops(7), chip.hbm_bw(7), chip.hbm_bytes(7)) == (
        hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.HBM_BYTES)
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == (
        989e12, 3.35e12, 80e9, 900e9)
    # 3g.40gb and 4g.40gb hold the same four memory slices of eight
    assert chip.hbm_bytes(3) == chip.hbm_bytes(4) == 40e9
    assert chip.hbm_bw(3) == chip.hbm_bw(4) == hw.HBM_BW / 2
    assert [chip.hbm_bytes(s) for s in (1, 2)] == [10e9, 20e9]
    for s in (1, 2, 3, 4):
        assert chip.flops(s) == pytest.approx(hw.PEAK_FLOPS_BF16 * s / 7, rel=1e-15)
    for bad in (0, 5, 6, 8, 16):
        with pytest.raises(ValueError, match="MIG"):
            chip.flops(bad)
        with pytest.raises(ValueError, match="MIG"):
            chip.hbm_bytes(bad)


def test_h100_profile_sizes_and_the_instances_each_arch_needs():
    """Over the paper's instance sizes: a model fits from the smallest
    instance whose memory slices hold its bf16 weights and one request's
    4,096-token cache within 90%; llama3-405b (812 GB), deepseek-v2-236b
    (472 GB) and deepseek-v3-671b fit none."""
    too_big = ("llama3-405b", "deepseek-v2-236b", "deepseek-v3-671b")
    p = h100_arch_profiles()
    assert tuple(p.sizes()) == (1, 2, 3, 4, 7)
    assert {a: p.min_size(a) for a in ARCH_IDS if a not in too_big} == {
        "qwen3-8b": 2, "mamba2-370m": 1, "zamba2-1.2b": 1, "granite-20b": 7,
        "phi4-mini-3.8b": 2, "internvl2-1b": 1, "musicgen-large": 1}
    for a in too_big:
        with pytest.raises(ValueError, match="fits on no instance"):
            p.min_size(a)
    # more of the card is never slower
    for a in ARCH_IDS:
        lat = [p.latency_ms(a, s, 8) for s in p.sizes()]
        assert lat == sorted(lat, reverse=True)


def _serve_correction(printed, arch, size):
    line = f"§8.3 feedback: measured correction for ({arch}, size={size}) = "
    return [ln[len(line):] for ln in printed.splitlines() if ln.startswith(line)]


@pytest.mark.parametrize("arch,size", [("qwen3-8b", 3), ("internvl2-1b", 1),
                                       ("llama3-405b", 7), ("deepseek-v2-236b", 7)])
def test_serve_cli_prints_the_measured_correction(tmp_path, capsys, arch, size):
    """The §8.3 line is the correction a MeasuredProfile round the H100 MIG
    profile gives for the run's measured throughput at ``--size``;
    llama3-405b and deepseek-v2-236b (the full configs the profile prices)
    fit no instance, so theirs stays at 1."""
    out = tmp_path / "stats.json"
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--batch", "2",
                "--new-tokens", "3", "--size", str(size), "--stats-json", str(out)])
    tput = json.loads(out.read_text())["throughput_rps"]
    want = MeasuredProfile(h100_arch_profiles([arch]))
    want.observe(arch, size, 2, tput)
    assert _serve_correction(capsys.readouterr().out, arch, size) == [
        f"{want.correction(arch, size):.4f}"]
    if arch in ("llama3-405b", "deepseek-v2-236b"):
        assert want.correction(arch, size) == 1.0


def test_serve_module_defaults_to_the_whole_card(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu --size 7``, as a
    user runs it."""
    out = tmp_path / "stats.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--size", "7",
         "--requests", "2", "--new-tokens", "2", "--stats-json", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    tput = json.loads(out.read_text())["throughput_rps"]
    want = MeasuredProfile(h100_arch_profiles(["qwen3-8b"]))
    want.observe("qwen3-8b", 7, 4, tput)  # the CLI's default batch
    assert _serve_correction(res.stdout, "qwen3-8b", 7) == [
        f"{want.correction('qwen3-8b', 7):.4f}"]
    assert 0.7 <= want.correction("qwen3-8b", 7) < 1.0


def test_serve_cli_takes_only_mig_sizes(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--size", "16"])
    assert "invalid choice" in capsys.readouterr().err
