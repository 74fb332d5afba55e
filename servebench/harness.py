"""One run of one cell: set-up, lead-in, the measured window, the metrics,
then the comparison with the plain reference.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json``, ``workloads/<cell>.json`` (traffic, engine settings,
lead-in, traced slice, the check's sample and limit),
``configs/<config>.json`` (the model as it is run), ``metrics/<metric>.py``
(one reader a metric), ``counts/<arch_type>.py`` and
``reference/<arch_type>.py``.  From the program it takes the engine, the
model and its kernels, and nothing else.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from servebench import check, stats, weights
from servebench.loop import Loop

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers see."""
    cfg: Dict  # the model's numbers (configs/<config>.json "model")
    workload: Dict
    window: tuple  # (t0, t1) on the host clock
    records: List
    admits: List
    steps: List
    setup_s: float
    trace: object = None  # profiling.TraceData of a --trace 1 run
    # the part of the window before the profiler started: the host-clock
    # per-layer metrics read it, free of the profiler's own cost
    quiet: tuple = None


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"servebench: no workload {name!r} in BENCHMARK.json")


def reader(name: str, base: Path = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"servebench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def wanted(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a cell asks its readers for: the end-to-end ones (or,
    with ``trace``, the per-layer ones) that list it or list no cells.  A
    reader that finds nothing to read in the cell leaves its metric out."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if name in m.get("workloads", (name,))]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: how fast the host runs
    the interpreter right now (the engine's dispatch is host-bound)."""
    t = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i & 7
    return 1e3 * (time.perf_counter() - t)


def log(*a) -> None:
    print(*a, flush=True)


class Cell:
    """A cell's files, the program's engine over the seed's weights, and
    the served traffic.  ``workload`` replaces the cell's file (tests)."""

    def __init__(self, name: str, seed: int, *, device: str = "cuda", base: Path = HERE,
                 workload: Optional[Dict] = None, t_proc: Optional[float] = None):
        self.t_proc = time.perf_counter() if t_proc is None else t_proc
        self.name, self.seed, self.device, self.base = name, seed, device, base
        self.w = workload or load_json(base / "workloads" / f"{name}.json")
        self.cfg = load_json(base / "configs" / f"{self.w['config']}.json")["model"]
        import torch

        from repro_torch.kernels import _build
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.transformer import Model

        self.torch, self.cuda = torch, device == "cuda"
        torch.set_num_threads(2)
        self.marks = {"imports": time.perf_counter()}
        if self.cuda:
            _build.build_all()
        self.marks["build"] = time.perf_counter()
        self.model = Model(ModelConfig(**self.cfg))
        self.params = weights.make_params(self.cfg, seed, device)
        self.sync()
        self.marks["weights"] = time.perf_counter()
        self.engine = None

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def new_engine(self):
        """A fresh engine as the cell states it, warmed on the cell's
        longest and shortest prompts and a few decode steps."""
        import numpy as np

        from repro_torch.serving.engine import Engine, Request

        e = self.w["engine"]
        self.engine = None
        eng = Engine(self.model, self.params, batch=e["batch"], max_len=e["max_len"],
                     kv_backend=e["kv_backend"], page_size=e.get("page_size", 16))
        if eng.kv_backend != e["kv_backend"]:
            raise SystemExit(f"servebench: engine took {eng.kv_backend!r}, the cell states "
                             f"{e['kv_backend']!r}")
        for i, L in enumerate((self.w["prompt"]["max"], self.w["prompt"]["min"])):
            prompt = np.random.default_rng([self.seed, 5, i]).integers(
                0, self.cfg["vocab_size"], L).astype(np.int32)
            eng.admit(Request(rid=-1 - i, max_new_tokens=4, prompt=prompt))
        while eng.num_live:
            eng.step()
        eng.step()
        self.sync()
        self.engine = eng
        self.marks["warm-up"] = time.perf_counter()
        return eng

    def serve(self, seconds: float, trace: bool = False, arrivals: Optional[Dict] = None,
              lead_in_s: Optional[float] = None) -> Run:
        """Lead-in, then the measured window of ``seconds``."""
        from repro_torch.kernels import ops

        tracer = None
        if trace:
            from servebench.profiling import Tracer

            tracer = Tracer(math.inf, self.cuda)
            tracer.warm()
        self.sync()
        gc.collect()
        gc.freeze()
        ops.reset_launches()
        lead = self.w["lead_in_s"] if lead_in_s is None else lead_in_s
        self.probe_ms = [host_probe_ms()]
        start = time.perf_counter()
        t0, t1 = start + lead, start + lead + seconds
        if tracer is not None:
            tracer.start = max(t0, t1 - self.w["trace_s"])
        drv = Loop(self.engine, self.w, self.seed, self.cfg["vocab_size"], arrivals=arrivals,
                     tracer=tracer)
        drv.run(start, t1)
        self.sync()
        self.overrun_s = time.perf_counter() - t1
        self.probe_ms.append(host_probe_ms())
        self.launches = ops.launches()
        self.parse_s = tracer.parse_s if tracer is not None else 0.0
        gc.unfreeze()
        return Run(self.cfg, self.w, (t0, t1), drv.records, drv.admits, drv.steps,
                   start - self.t_proc, tracer.data if tracer is not None else None,
                   (t0, tracer.start if tracer is not None else t1))

    def free(self) -> None:
        """Drop the program's state (engine, weights), so that the reference
        sets no peak and finds the memory free."""
        self.engine = self.params = self.model = None
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def setup_line(self, setup_s: float) -> Dict:
        prev, split = self.t_proc, {}
        for k, v in self.marks.items():
            split[f"{k}_s"], prev = v - prev, v
        return {"setup": self.name, "setup_s": setup_s, **split,
                "weights_gb": weights.nbytes(self.cfg) / 1e9}


def summary(name: str, run: Run, cell: Cell) -> Dict:
    """The earlier line: counts and medians over the window, what it left queued."""
    t1 = run.window[1]
    due = stats.due_in_window(run)
    steps, admits = stats.calls_in_window(run, run.steps), stats.calls_in_window(run, run.admits)
    return {"summary": name, "due": len(due),
            "finished": sum(1 for r in run.records if not math.isnan(r.finished)),
            "admissions": len(admits), "steps": len(steps),
            "tokens": stats.tokens_in_window(run),
            "ttft_p50_s": stats.percentile(stats.ttfts(run), 50),
            "ttft_p90_s": stats.percentile(stats.ttfts(run), 90),
            "itl_p50_ms": 1e3 * stats.percentile(stats.gaps(run), 50),
            "itl_p95_ms": 1e3 * stats.percentile(stats.gaps(run), 95),
            "queue_wait_p50_s": stats.percentile(stats.queue_waits(run), 50),
            "mean_live": (sum(len(c.lens) for c in steps) / len(steps)) if steps else 0,
            "backlog_at_close": sum(1 for r in run.records if r.due < t1 and not r.admit_start < t1),
            "launches": cell.launches, "overrun_s": cell.overrun_s, "trace_parse_s": cell.parse_s,
            "host_probe_ms": cell.probe_ms,
            "step_ms_p50": 1e3 * stats.percentile([c.end - c.start for c in steps], 50),
            "admit_ms_p50": 1e3 * stats.percentile([c.end - c.start for c in admits], 50)}


def finished(run: Run) -> List:
    return [r for r in run.records if not math.isnan(r.finished) and not r.error]


def compare(cell: Cell, run: Run, control: bool = False) -> Dict:
    """The reference's reading of a sample of ``run``'s finished requests."""
    picked = check.sample(finished(run), cell.seed, cell.w["check"]["requests"])
    t = time.perf_counter()
    res = (check.compare(cell.cfg, cell.seed, picked, [r.prompt for r in picked], cell.device,
                         control)
           if picked else {"gap": math.inf, "tokens": 0.0})
    res["sampled"] = len(picked)
    log(json.dumps({"check": cell.name, "seconds": time.perf_counter() - t, **res,
                    "requests": [[r.index, r.prompt_len, len(r.tokens)] for r in picked]}))
    return res


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             bench: Optional[Dict] = None, base: Path = HERE, t_proc: Optional[float] = None,
             workload: Optional[Dict] = None) -> Dict:
    """One run: the result line's object, and under ``"_run"`` the stamps
    and under ``"_forbidden"`` any JAX module the process holds."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cell_ = Cell(name, seed, device=device, base=base, workload=workload, t_proc=t_proc)
    cell_.new_engine()
    run = cell_.serve(seconds, trace)
    torch = cell_.torch
    log(json.dumps(cell_.setup_line(run.setup_s)))
    peak = torch.cuda.max_memory_allocated() if cell_.cuda else 0

    metrics: Dict[str, Dict] = {}
    for m in wanted(bench, name, trace):
        v = reader(m["name"], base)(run)
        if v is None:
            print(f"servebench: {m['name']}: nothing to read", file=sys.stderr)
        else:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = stats.due_in_window(run)
    failed = sum(1 for r in due if r.error)
    log(json.dumps({**summary(name, run, cell_), "seed": seed, "trace": int(trace)}))

    cell_.free()
    res = compare(cell_, run)
    limit = cell_.w["check"]["max_logit_gap"]
    checks = {
        # a gap that is not a number (no sample, a token outside the
        # vocabulary, a non-finite logit) is reported as null and fails
        "logit_gap": {"value": res["gap"] if math.isfinite(res["gap"]) else None,
                      "limit": limit},
        "failed_requests": {"value": failed, "limit": 0},
        "sampled_requests": {"value": res["sampled"], "limit": 1},
    }
    correct = res["gap"] <= limit and failed == 0 and res["sampled"] >= 1
    dev = {"platform": "gpu" if cell_.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cell_.cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(due), "failed": failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        from servebench import profiling

        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": profiling.top_ops(run.trace),
                            "idle_gaps": profiling.idle_gaps(run.trace)}
    out["checks"] = checks
    out["_run"] = run
    # modules are never unloaded: what the process holds now, it held
    # when the window closed
    out["_forbidden"] = forbidden_modules()
    return out


def main(args, t_proc: float) -> int:
    """The command line's run: refuses without the card, prints the result
    line last on stdout and the compared numbers last on stderr."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"servebench: the cell needs {entry['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log(json.dumps({"device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                    "name_power_limit": power_limit(), "torch": torch.__version__,
                    "cuda": torch.version.cuda}))
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench,
                   t_proc=t_proc)
    if out["_forbidden"]:
        print(f"servebench: the run loaded {out['_forbidden']}", file=sys.stderr)
        return 3
    checks = out["checks"]
    line = {k: v for k, v in out.items() if not k.startswith("_")}
    log(json.dumps(line))
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0
