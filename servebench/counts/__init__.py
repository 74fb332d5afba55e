"""The yardstick's counts of work, from shapes alone.

``kernels`` holds each kernel's operations and bytes for one call;
``<arch_type>.py`` (``dense``, ``ssm``) holds a whole admission's and a
whole decode step's, found by the config's ``arch_type``.  ``peaks.json``
holds the card's data-sheet rates.  Every count is of what the inputs
need: the true prompt length (no padding), the live slots' contexts (no
idle slot), each input read once and each output written once.  Nothing
here reads the program: a later kernel, whatever implements it, is held
to the same work.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict

PEAKS: Dict[str, float] = json.loads((Path(__file__).parent / "peaks.json").read_text())


def seconds(flops: Dict[str, float], nbytes: float) -> float:
    """Roofline time: the larger of the operations at their precision's
    peak (``flops`` maps "bf16" / "tf32" to a count) and the bytes at the
    memory's rate."""
    compute = sum(n / PEAKS[f"{prec}_flops_per_s"] for prec, n in flops.items())
    return max(compute, nbytes / PEAKS["hbm_bytes_per_s"])


def family(cfg: Dict):
    """The step counts of ``cfg``'s architecture (``counts/<arch_type>.py``)."""
    return importlib.import_module(f"servebench.counts.{cfg['arch_type']}")
