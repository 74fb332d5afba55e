"""The knee sweep of an open-loop cell: the cell's traffic at a few
multiples of its rate, one process, one set of weights.

    python3 servebench/sweep.py --workload granite-20b.chat --seed <n> \\
        --factors 0.8,1.0,1.2 --seconds 30 --lead-in 15

prints one line a rate: the mean rate offered, requests due and admitted
in the window, the backlog left at its close, time to first token and
tokens/s.  The knee is the highest rate whose backlog does not grow
through the window; the cell's rate is written into its workload file
as a number (this script is run once, when a cell is defined).
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--factors", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--lead-in", type=float, default=None)
    ap.add_argument("--steady", action="store_true",
                    help="one Poisson phase at the cell's mean rate, its bursts left out")
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(root), str(root / "src")]
    import torch

    from servebench import harness, stats, traffic

    if not torch.cuda.is_available():
        print("servebench: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload, args.seed, t_proc=T_PROC)
    base = cell.w["arrivals"]
    if args.steady:
        period = traffic.period_s(base)
        base = {"phases": [{"seconds": period, "rate": traffic.mean_rate(base)}]}
    for f in (float(x) for x in args.factors.split(",")):
        arr = traffic.scaled(base, f)
        cell.new_engine()
        run = cell.serve(args.seconds, arrivals=arr, lead_in_s=args.lead_in)
        t0, t1 = run.window
        due = stats.due_in_window(run)
        line = harness.summary(args.workload, run, cell)
        line.update(factor=f, offered_rps=traffic.mean_rate(arr),
                    admitted_in_window=sum(1 for r in run.records if t0 <= r.admit_start < t1),
                    backlog_at_open=sum(1 for r in run.records
                                        if r.due < t0 and not r.admit_start < t0),
                    tokens_per_s=stats.tokens_in_window(run) / (t1 - t0),
                    queue_wait_p90_s=stats.percentile(stats.queue_waits(run), 90),
                    itl_p95_ms=1e3 * stats.percentile(stats.gaps(run), 95),
                    due_in_window=len(due))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
