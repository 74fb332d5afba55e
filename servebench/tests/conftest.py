"""servebench's own tests: ``python -m pytest servebench/tests`` from the
repo root.  They run on the CPU; tests marked ``card`` skip there."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SB = ROOT / "servebench"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TINY = {
    "dense": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
                  d_ff=256, vocab_size=512),
    "ssm": dict(num_layers=2, d_model=128, vocab_size=512, ssm_state=16, ssm_head_dim=32,
                ssm_chunk=16),
}


def tiny_cfg(config: str) -> dict:
    """The named configuration's file at a test's widths."""
    c = json.loads((SB / "configs" / f"{config}.json").read_text())
    c["model"].update(TINY[c["model"]["arch_type"]])
    return c


def tiny_workload(cell: str, config: str) -> dict:
    """The cell's workload at a test's sizes and seconds."""
    w = json.loads((SB / "workloads" / f"{cell}.json").read_text())
    w.update(config=config, lead_in_s=0.5, trace_s=0.5)
    w["prompt"].update(median=24, min=8, max=64)
    w["output"].update(median=8, min=4, max=12)
    w["engine"].update(max_len=128, batch=4)
    if w["loop"] == "open":
        w["arrivals"] = {"phases": [{"seconds": 1.0, "rate": 30.0}]}
    else:
        w.update(clients=6, block=4)
    w["check"]["requests"] = 4
    return w


@pytest.fixture
def tiny_base(tmp_path):
    """A servebench folder holding tiny configurations and cells
    (``tiny.chat``, ``tiny.burst``, ``tiny.code``), with the real metric
    readers; returns (its path, the benchmark file's object)."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").symlink_to(SB / "metrics")
    for name in ("granite-20b", "mamba2-370m"):
        (tmp_path / "configs" / f"tiny-{name}.json").write_text(json.dumps(tiny_cfg(name)))
    for cell, src, conf in (("tiny.chat", "granite-20b.chat", "tiny-granite-20b"),
                            ("tiny.burst", "mamba2-370m.burst", "tiny-mamba2-370m"),
                            ("tiny.code", "granite-20b.code", "tiny-granite-20b")):
        (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps(tiny_workload(src, conf)))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w.replace("granite-20b.", "tiny.").replace("mamba2-370m.", "tiny.")
                              for w in m["workloads"]]
    return tmp_path, bench
