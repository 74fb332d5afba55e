"""Plain float32 references of the served models, and their lower-precision
control.

Each family module (``reference/<arch_type>.py``) writes out, in plain
torch, the equations the port implements for that architecture, over the
full sequence (no cache, no batching, no kernel), and makes every weight
again from the seed (:mod:`servebench.weights`), layer by layer, so that
it fits beside nothing and takes nothing the program made.  It imports
neither the program nor JAX.

:func:`logits` runs a family's reference over each sequence and returns
the logits of the positions asked for, in float32 ("fp32") and, on
request, in the control's precision ("fp8": every matrix product's
operands rounded to float8 e4m3 with one scale a tensor, the step below
the bfloat16 the configurations state).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import torch


def logits(cfg: Dict, seed: int, seqs: Sequence[torch.Tensor], starts: Sequence[int],
           device, precisions: Sequence[str] = ("fp32",)) -> Dict[str, List[torch.Tensor]]:
    """``{precision: [(len(seq) - start, vocab) float32 logits of positions
    start.. of each sequence]}``; TF32 is switched off for the float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam = importlib.import_module(f"servebench.reference.{cfg['arch_type']}")
    with torch.no_grad():
        return fam.logits(cfg, seed, seqs, starts, torch.device(device), tuple(precisions))
