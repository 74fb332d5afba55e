"""The readings the correctness limit is set from, on the card, at the
cell's own size and load: per seed, the program's widest logit gap over a
run's sample (the lower reading), and on the control seeds the control's
(the upper reading): the reference put in the program's place in float8
e4m3 products, read as the float32 reference's gap of the token the
float8 forward puts first, at every position of the same prompts and
served tokens.  One process for all seeds; each seed makes its weights
anew and serves a lead-in and a window as a run does.

    python3 servebench/control.py --workload <cell> --seeds a,b,c \\
        --control-seeds a,b --seconds 50

The benchmark's runs never run this; the test of the same comparison at
a test's size is tests/test_sb_control.py.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(root), str(root / "src")]
    import torch

    from servebench import harness

    if not torch.cuda.is_available():
        print("servebench: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(args.workload, seed)
        cell.new_engine()
        run = cell.serve(args.seconds)
        cell.free()
        res = harness.compare(cell, run, control=seed in controls)
        rows.append({"seed": seed, **res})
        print(json.dumps({"reading": args.workload, **rows[-1]}), flush=True)
        del cell, run
    prog = [r["gap"] for r in rows]
    ctrl = [r["control_gap"] for r in rows if "control_gap" in r]
    print(json.dumps({"readings": args.workload, "program_max": max(prog),
                      "program": prog, "control_min": min(ctrl) if ctrl else None,
                      "control": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
