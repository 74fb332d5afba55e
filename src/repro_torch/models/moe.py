"""Mixture-of-Experts layer (DeepSeek style: shared and routed experts, top-k).

The port of ``moe_init``, ``capacity`` and ``moe_forward`` of the JAX
package's ``models/moe.py``.  Dispatch is by capacity: each token's ``k``
assignments are placed, in arrival order over the flattened ``(T*k)``
assignments, into an ``(E, C, d)`` expert buffer; assignments past an
expert's ``C`` slots are dropped.  The expert SwiGLU is a batched product
over ``E``, and the outputs are gathered back and weighted by the
renormalised router probabilities.  The router runs in float32; the
Switch-style load-balance loss is returned beside the output.

A dropped assignment is parked at slot ``C-1`` with a zero weight, as in
the reference, and the buffer is filled by an accumulating
``index_put_``: each ``(expert, slot)`` then receives one real token plus
exact zeros, so the result does not depend on the order of the card's
atomic adds.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_forward, mlp_specs


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    specs: Dict[str, ParamSpec] = {
        "router": ((d, E), "normal", 0.02),
        "we_gate": ((E, d, ff), "normal", None),
        "we_up": ((E, d, ff), "normal", None),
        "we_down": ((E, ff, d), "normal", None),
    }
    if cfg.num_shared_experts:
        shared = mlp_specs(cfg, d_ff=ff * cfg.num_shared_experts)
        specs.update({f"shared/{k}": s for k, s in shared.items()})
    return specs


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``capacity_factor`` times the even share of the
    ``tokens * k`` assignments, rounded up to a multiple of 8, at least 8."""
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row, largest first, ties to the lower index
    (as ``jax.lax.top_k``; ``torch.topk`` promises no order among ties)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def moe_forward(
    p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).  Every row takes part,
    idle decode rows included, as in the reference: they compete for
    capacity in arrival order."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, d)

    logits = xf.float() @ p["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)  # (T, k)
    w = w / w.sum(dim=-1, keepdim=True)  # DeepSeek renormalises the top-k

    C = capacity(T, cfg)
    idx_f = idx.reshape(T * k)
    w_f = w.reshape(T * k).to(x.dtype)
    onehot = F.one_hot(idx_f, E)  # (T*k, E)
    pos_f = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)  # slot within expert
    keep = (pos_f < C).to(x.dtype)
    safe_pos = pos_f.clamp(max=C - 1)

    xk = xf[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((idx_f, safe_pos), xk * keep[:, None], accumulate=True)

    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    hout = torch.bmm(h, p["we_down"])  # (E, C, d)

    gathered = hout[idx_f, safe_pos] * (keep * w_f)[:, None]  # (T*k, d)
    out = gathered.reshape(T, k, d).sum(dim=1)
    if cfg.num_shared_experts:
        out = out + mlp_forward(p["shared"], xf)

    # Switch-style load-balance loss
    frac = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()
    return out.reshape(B, S, d), aux
