"""The harness finds a new cell and a new per-layer metric by their names
alone: files added to a copy of the folder, no code edited."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT, SB, tiny_cfg, tiny_workload

READER = '''
"""A metric a later change might add: decode steps in the window."""

from servebench import stats


def read(run):
    return float(len(stats.calls_in_window(run, run.steps)))
'''


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(SB, tmp_path / "servebench", ignore=shutil.ignore_patterns("__pycache__"))
    sb = tmp_path / "servebench"
    (sb / "configs" / "toy.json").write_text(json.dumps(tiny_cfg("granite-20b")))
    (sb / "workloads" / "toy.chat.json").write_text(
        json.dumps(tiny_workload("granite-20b.chat", "toy")))
    (sb / "metrics" / "engine.steps_in_window.py").write_text(READER)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "toy.chat", "config": "toy", "traffic": "chat",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "engine.steps_in_window", "unit": "count",
                               "better": "higher", "source": "host_clock", "layer": "engine",
                               "moves": "tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from servebench import harness\n"
        "for trace in (0, 1):\n"
        "    out = harness.run_cell('toy.chat', 11, 1.0, bool(trace), device='cpu')\n"
        "    print('RESULT', json.dumps(sorted(out['metrics'])), out['correct'])\n"
    ) % (str(tmp_path), str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    e2e, per_layer = (json.loads(ln.split(" ", 1)[1].rsplit(" ", 1)[0]) for ln in lines)
    assert e2e == ["setup_s", "tokens_per_s"]  # ttft_p90_s lists the code cell alone
    assert "engine.steps_in_window" in per_layer
    assert all(ln.endswith("True") for ln in lines)
