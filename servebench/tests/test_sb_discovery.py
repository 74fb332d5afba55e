"""The harness finds a new cell and a new per-layer metric by their names
alone, and a whole new model family with them: files added to a copy of
the folder and entries appended to its ``BENCHMARK.json``, no code and no
existing file edited."""

import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT, SB, tiny_cfg, tiny_workload
from test_sb_layouts import MOE

from repro_torch.configs import get_smoke_config
from servebench import harness

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


COUNTS = '''
"""The test's own counts of the MoE family (MLA attention, routed and shared
experts): every token's active weights and its attention over the context,
each weight and cached row read once.  A configuration of the family brings
the yardstick's."""

from servebench import weights


def _attn(cfg):
    d, H = cfg["d_model"], cfg["num_heads"]
    qr, r = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nd, rd, vd = cfg["nope_head_dim"], cfg["rope_head_dim"], cfg["v_head_dim"]
    return d * qr + qr * H * (nd + rd) + d * (r + rd) + r * H * (nd + vd) + H * vd * d


def _active(cfg):
    d, n, L = cfg["d_model"], cfg["first_dense_layers"], cfg["num_layers"]
    expert = 3 * d * cfg["moe_d_ff"]
    moe = d * cfg["num_experts"] + expert * (cfg["experts_per_token"] + cfg["num_shared_experts"])
    return L * _attn(cfg) + n * 3 * d * cfg["d_ff"] + (L - n) * moe


def _context(cfg, c):
    """Attention operations of one token over ``c`` positions, every layer."""
    H, nd, rd, vd = (cfg["num_heads"], cfg["nope_head_dim"], cfg["rope_head_dim"],
                     cfg["v_head_dim"])
    return 2.0 * c * H * (nd + rd + vd) * cfg["num_layers"]


def _row(cfg):
    return 2.0 * (cfg["kv_lora_rank"] + cfg["rope_head_dim"]) * cfg["num_layers"]


def prefill(cfg, L):
    d, V = cfg["d_model"], cfg["vocab_size"]
    flops = 2.0 * L * _active(cfg) + _context(cfg, L * (L + 1) / 2) + 2.0 * d * V
    return {"bf16": flops}, weights.nbytes(cfg) + 2.0 * L * d + L * _row(cfg) + 2.0 * V


def decode(cfg, lens):
    d, V, B = cfg["d_model"], cfg["vocab_size"], len(lens)
    flops = 2.0 * B * (_active(cfg) + d * V) + _context(cfg, sum(lens))
    nbytes = weights.nbytes(cfg) + sum(lens) * _row(cfg) + B * (2.0 * d + 2.0 * V)
    return {"bf16": flops}, nbytes
'''

REFERENCE = '''
"""The test's own reference of the MoE family: the port's ``Model.forward``
in float32 over the seed's weights, with room for every token at every
expert.  It stands in for a plain reference, since the test checks that the
harness finds a family by name and not the model; a configuration of the
family brings one that imports nothing of the program."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from servebench import weights


def _f32(t):
    return {k: _f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()


def logits(cfg, seed, seqs, starts, device, precisions):
    model = Model(ModelConfig(**{**cfg, "dtype": "float32",
                                 "capacity_factor": float(cfg["num_experts"])}))
    params = _f32(weights.make_params(cfg, seed, device))
    out = [model.forward(params, tokens=s[None].to(device))[0][0, a:, :cfg["vocab_size"]]
           for s, a in zip(seqs, starts)]
    return {"fp32": out}
'''

SPAN_READER = '''
"""Share of the traced decode steps' model time (``engine.step.model``)
spent inside ``model.mlp`` spans, in %: the experts of an eager MoE step.
A granite cell replays its decode step as one CUDA graph, whose steps hold
no such span."""

from servebench import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    steps = spans.union((s, e) for s, e, n in t.cpu_ops if n == "engine.step.model")
    mlp = spans.intersect(spans.union((s, e) for s, e, n in t.cpu_ops if n == "model.mlp"),
                          steps)
    if not mlp:
        return None
    return 100.0 * sum(e - s for s, e in mlp) / sum(e - s for s, e in steps)
'''

# metrics of every cell, whatever its family; the first three on the host clock
FAMILY_AGNOSTIC = ["engine.decode_step_ms", "mfu.prefill", "mfu.decode", "device.idle_share",
                   "device.kernels_per_decode_step", "engine.idle_dispatch_share",
                   "engine.idle_host_share"]
FAMILY = ["layouts/moe.py", "counts/moe.py", "reference/moe.py"]


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_a_new_family_joins_as_files_alone(tmp_path, request, device):
    """A MoE cell at the port's deepseek-v2 smoke widths on the flat cache:
    the family's layout, counts and reference (in place of any shipped file
    of those names), a config, a workload and a metric of its own are added,
    and the harness runs the cell untraced and traced with ``correct`` true.
    Every file the copy held before is unchanged but those three."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    assert get_smoke_config("deepseek-v2-236b").arch_type == "moe"
    sb = tmp_path / "servebench"
    shutil.copytree(SB, sb, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(sb)
    for rel, src in zip(FAMILY, (MOE, COUNTS, REFERENCE)):
        (sb / rel).write_text(src)
    model = dataclasses.asdict(get_smoke_config("deepseek-v2-236b"))
    # room for every assignment: the engine drops none, as the reference
    model["capacity_factor"] = model["num_experts"] / model["experts_per_token"]
    (sb / "configs" / "toy-moe.json").write_text(json.dumps(
        {"name": "toy-moe", "source": "https://arxiv.org/abs/2405.04434", "model": model}))
    w = tiny_workload("granite-20b.chat", "toy-moe")
    w["engine"]["kv_backend"] = "flat"
    # sound runs read 0 to 0.84 over 38 seeds: a router near a tie picks
    # other experts in bf16 than in float32 (on the widest seed the port's own
    # bf16 forward reads 0)
    w["check"]["max_logit_gap"] = 2.5
    (sb / "workloads" / "toy-moe.chat.json").write_text(json.dumps(w))
    (sb / "metrics" / "model.decode_mlp_share.py").write_text(SPAN_READER)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-moe", "source": "https://arxiv.org/abs/2405.04434",
                             "file": "servebench/configs/toy-moe.json",
                             "reduced": ["capacity_factor"],
                             "why": "MLA attention and routed experts at a test's widths"})
    bench["workloads"].append({"name": "toy-moe.chat", "config": "toy-moe", "traffic": "chat",
                               "chips": 1, "why": "a test cell of a new family"})
    bench["per_layer"].append({"name": "model.decode_mlp_share", "unit": "%", "better": "lower",
                               "source": "program_span", "layer": "model step",
                               "moves": "tokens_per_s", "workloads": ["toy-moe.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in ("granite-20b.chat", "granite-20b.code"):
        assert "model.decode_mlp_share" not in [m["name"] for m in
                                                harness.wanted(bench, cell, True)]

    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from servebench import harness\n"
        "assert harness.__file__.startswith(%r), harness.__file__\n"
        "for trace in (0, 1):\n"
        "    out = harness.run_cell('toy-moe.chat', 2**31 + 23, 2.0, bool(trace), device=%r)\n"
        "    metrics = {k: v['value'] for k, v in out['metrics'].items()}\n"
        "    print('RESULT', json.dumps({'metrics': metrics, 'correct': out['correct'],"
        " 'checks': out['checks']}))\n"
    ) % (str(tmp_path), str(ROOT / "src"), str(sb), device)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    untraced, traced = (json.loads(ln.split(" ", 1)[1]) for ln in res.stdout.splitlines()
                        if ln.startswith("RESULT"))
    logs = [ln for ln in res.stdout.splitlines() if ln.startswith(('{"check"', '{"summary"'))]
    assert untraced["correct"] and traced["correct"], logs
    assert sorted(untraced["metrics"]) == ["setup_s", "tokens_per_s"]
    # every metric the cell asks for is read, or says it found nothing to read
    quiet = {ln.split(": ")[1] for ln in res.stderr.splitlines()
             if ln.startswith("servebench: ") and ln.endswith(": nothing to read")}
    asked = set(traced["metrics"]) | quiet
    assert set(FAMILY_AGNOSTIC + ["model.decode_mlp_share"]) <= asked
    # a CPU trace holds no device operation: the four device-trace readers find nothing there
    read_here = FAMILY_AGNOSTIC[:3] if device == "cpu" else FAMILY_AGNOSTIC
    assert set(read_here + ["model.decode_mlp_share"]) <= set(traced["metrics"]), quiet
    assert 0 < traced["metrics"]["model.decode_mlp_share"] < 100

    after = digests(sb)
    assert {k: after[k] for k in before if k not in FAMILY} == {
        k: v for k, v in before.items() if k not in FAMILY}
