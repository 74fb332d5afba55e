"""AdamW with global-norm gradient clipping, by hand.

The port of the JAX package's ``training/adamw.py``, step for step: the
learning rate comes from the old step and the bias corrections from the
new one; weight decay applies to every leaf, norms included, as
``lr · (m̂/(√v̂+ε) + wd·p)``; moments are float32 and each new parameter
is cast back to its own dtype.  (``torch.optim.AdamW`` decays and orders
its steps otherwise.)  The scalars are computed in float32, as the
reference's are.

The update runs under ``torch.no_grad()`` leaf by leaf and in place: the
moments and parameters are overwritten, and only one leaf's float32
temporaries live at a time.  It still returns ``(params, state, gnorm)``
as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.models.common import flatten, unflatten

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def init(params: Tree) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in flatten(params).items()}
    return AdamWState(step=0, mu=unflatten(zeros),
                      nu=unflatten({k: z.clone() for k, z in zeros.items()}))


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to ``lr``, in float32."""
    f32 = np.float32
    warm = min(f32(1.0), f32(step + 1) / f32(max(1, cfg.warmup_steps)))
    return float(f32(cfg.lr) * warm)


@torch.no_grad()
def update(
    cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree
) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """Returns (params, state, grad_norm): the pre-clip global norm, a
    float32 scalar on the device (no host sync).  ``params`` and the
    state's moments are updated in place."""
    flat_g, flat_m, flat_v, flat_p = (flatten(t) for t in (grads, state.mu, state.nu, params))
    gnorm = torch.stack([g.float().square().sum() for g in flat_g.values()]).sum().sqrt()
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    f32 = np.float32
    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(step))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(step))
    for key, p in flat_p.items():
        m, v = flat_m[key], flat_v[key]
        g = flat_g[key].float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        upd = m / b1c
        upd.div_((v / b2c).sqrt_().add_(cfg.eps))
        p32 = p.float()
        upd.add_(p32 * cfg.weight_decay)
        p.copy_(p32 - upd.mul_(lr))
    return params, AdamWState(step, state.mu, state.nu), gnorm
