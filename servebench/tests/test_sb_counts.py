"""The frozen counts against numbers worked out by hand at granite-20b's
and mamba2-370m's shapes."""

import json

import pytest
from conftest import SB

from servebench import counts
from servebench.counts import dense, kernels, ssm

GRANITE = json.loads((SB / "configs" / "granite-20b.json").read_text())["model"]
MAMBA = json.loads((SB / "configs" / "mamba2-370m.json").read_text())["model"]


def test_peaks_are_the_data_sheet_rates():
    assert counts.PEAKS["bf16_flops_per_s"] == 989e12
    assert counts.PEAKS["tf32_flops_per_s"] == 495e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12
    # the longer of compute and memory
    assert counts.seconds({"bf16": 989e12}, 1.0) == pytest.approx(1.0)
    assert counts.seconds({"bf16": 1.0}, 6.7e12) == pytest.approx(2.0)
    assert counts.seconds({"bf16": 989e12, "tf32": 495e12}, 0.0) == pytest.approx(2.0)


def test_granite_20b_weights_and_cache():
    # q, k, v, o: 6144 x (48 + 2) x 128 + 48 x 128 x 6144; GELU MLP: 2 x 6144 x 24576
    assert dense.layer_params(GRANITE) == 379_060_224
    assert dense.kv_bytes_per_token(GRANITE) == 26_624  # 2 x 2 B x 128 x 52 layers
    # 52 layers and their two norms, the head and the final norm, bf16
    assert dense.weight_bytes(GRANITE) == 40_027_533_312


def test_granite_20b_admission_and_decode_step():
    flops, nbytes = dense.prefill(GRANITE, 1024)
    # (2 x 1024 x 379,060,224 + 4 x 48 x 128 x 524,800 causal pairs) x 52 + the head's 2 x 6144 x 49152
    assert flops["bf16"] == 41_039_670_804_480
    assert nbytes == 40_027_533_312 + 2 * 1024 * 6144 + 1024 * 26_624 + 2 * 49152
    lens = [1500] * 32
    flops, nbytes = dense.decode(GRANITE, lens)
    assert nbytes == 41_309_024_256  # weights + 48,000 cached tokens + 32 rows in and out
    assert counts.seconds(flops, nbytes) == pytest.approx(41_309_024_256 / 3.35e12)


def test_granite_20b_kernels():
    flops, nbytes = kernels.flash_attention(1024, 48, 1, 128)
    assert flops == {"bf16": 12_897_484_800} and nbytes == 25_690_112
    assert counts.seconds(flops, nbytes) == pytest.approx(12_897_484_800 / 989e12)  # compute-bound
    flops, nbytes = kernels.paged_attention([1500] * 32, 48, 1, 128, 16)
    assert flops == {"bf16": 1_179_648_000}
    # k/v rows (2 x 48,000 x 128) and q/out (2 x 32 x 48 x 128) in bf16, 32 x 94 page ids, 32 lengths
    assert nbytes == 25_374_592


def test_mamba2_370m_step_counts():
    assert ssm.layer_params(MAMBA) == 6_586_368  # 1024 x (2048 + 2304 + 32) + 2048 x 1024
    assert ssm.state_bytes(MAMBA) == 50_995_200  # 48 x (4 x 32 x 64 x 128 + 2 x 3 x 2304)
    flops, nbytes = kernels.ssm_scan(256, 32, 64, 128, 128)
    # 2 chunks x 8,256 pairs x 2 x (128 + 2048), plus 4 x 256 x 32 x 64 x 128
    assert flops == {"tf32": 340_295_680}
    assert nbytes == 5_537_920
    f, _ = ssm.prefill(MAMBA, 256)
    assert f["tf32"] == 48 * 340_295_680
    assert f["bf16"] == 48 * 2 * 256 * (6_586_368 + 2304 * 4) + 2 * 1024 * 50277
    f, b = ssm.decode(MAMBA, [300] * 64)
    assert b == ssm.weight_bytes(MAMBA) + 2 * 64 * 1024 + 2 * 64 * 50_995_200 + 2 * 64 * 50277
