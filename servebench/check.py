"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the finished requests, drawn from
the seed and holding the one with the most served tokens, goes through
the plain float32 reference over its prompt and served tokens.  At every
served position the gap is the reference's best logit minus its logit of
the token the engine served (0 where they agree); the number compared is
the widest gap, against the cell's limit.  Greedy decoding makes this
valid: a correct engine serves the reference's best token up to rounding,
so a gap can only come from a near tie.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from servebench import reference


def sample(finished: Sequence, seed: int, k: int) -> List:
    """Up to ``k`` finished requests: the one with the most served tokens,
    then others drawn from the seed."""
    if not finished:
        return []
    pool = sorted(finished, key=lambda r: r.index)
    longest = max(pool, key=lambda r: (len(r.tokens), r.prompt_len))
    rest = [r for r in pool if r is not longest]
    rng = np.random.default_rng([seed, 4])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs: Sequence, prompts: Sequence[np.ndarray]) -> Tuple[List[torch.Tensor], List[int]]:
    """Each request's prompt and served tokens but the last (the reference's
    input), and the position whose logits predict the first served token."""
    seqs, starts = [], []
    for r, p in zip(reqs, prompts):
        toks = np.concatenate([np.asarray(p, np.int64), np.asarray(r.tokens[:-1], np.int64)])
        seqs.append(torch.from_numpy(toks))
        starts.append(len(p) - 1)
    return seqs, starts


def widest_gap(logits: Sequence[torch.Tensor], served: Sequence[Sequence[int]]) -> float:
    """Widest (reference best - reference logit of the served token)."""
    worst = 0.0
    for lg, toks in zip(logits, served):
        t = torch.as_tensor(list(toks), dtype=torch.int64, device=lg.device)
        if t.numel() and ((t < 0) | (t >= lg.shape[-1])).any():
            return float("inf")  # a token outside the vocabulary
        gap = lg.max(dim=-1).values - lg.gather(-1, t[:, None])[:, 0]
        if not torch.isfinite(gap).all():
            return float("inf")
        worst = max(worst, float(gap.max()))
    return worst


def control_gap(ref: Sequence[torch.Tensor], low: Sequence[torch.Tensor]) -> float:
    """The control's reading: at each position, the reference's gap of the
    token that the lower precision puts first."""
    return widest_gap(ref, [lg.argmax(dim=-1).tolist() for lg in low])


def compare(cfg: Dict, seed: int, reqs: Sequence, prompts: Sequence[np.ndarray], device,
            control: bool = False) -> Dict[str, float]:
    """``{"gap": widest gap of the served tokens, "tokens": tokens compared}``,
    and with ``control`` the control's reading as ``"control_gap"``."""
    seqs, starts = sequences(reqs, prompts)
    precs = ("fp32", "fp8") if control else ("fp32",)
    out = reference.logits(cfg, seed, seqs, starts, device, precs)
    res = {"gap": widest_gap(out["fp32"], [r.tokens for r in reqs]),
           "tokens": float(sum(len(r.tokens) for r in reqs))}
    if control:
        res["control_gap"] = control_gap(out["fp32"], out["fp8"])
    return res
