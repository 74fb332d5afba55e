"""The benchmark's command: one run of one cell.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  See servebench/README.md.
"""

import time

T_PROC = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    # the checkout root (not this folder) and the program's sources
    sys.path[0:1] = [str(root), str(root / "src")]
    from servebench import harness

    return harness.main(args, T_PROC)


if __name__ == "__main__":
    sys.exit(main())
