"""Training step: loss, gradients, AdamW update.

The port of the JAX package's ``training/train_loop.py``.  Loss = causal
cross-entropy (+ the MoE load-balance aux loss, + DeepSeek-V3's MTP head
when configured).  ``make_train_step`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
the parameters need not require grad (the step differentiates views of
them) and are updated in place.  Metrics are device scalars.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import embedding, flatten, rmsnorm, settle, unflatten
from repro_torch.models.transformer import Model
from repro_torch.training import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # DTensor logits sharded over the vocabulary are gathered whole first
    # (DTensor takes no gather over a sharded dimension)
    logits = settle(logits).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def _mtp_loss(model: Model, params: Any, h: torch.Tensor, batch: Dict) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction, depth 1: predict label_{t+1}
    (the token two ahead) from [h_t ; embed(label_t)] through the MTP
    projection and the shared output head."""
    labels = batch["labels"]
    emb_next = embedding(params["embed"], labels)  # label_t = token t+1
    feat = torch.cat([h[:, :-1], emb_next[:, :-1]], dim=-1)
    mtp = params["mtp"]
    # the projection's output made whole over its features, as the residual
    # stream is (settle): its gradient then comes back feature-sharded, and
    # not sharded over the 255 uneven positions, which DTensor cannot
    # multiply by featᵀ
    h_mtp = rmsnorm(settle(feat @ mtp["proj"]), mtp["norm"], model.cfg.norm_eps)
    return cross_entropy(model.logits(params, h_mtp), labels[:, 1:])


def make_loss_fn(model: Model):
    cfg = model.cfg

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h, aux = model.hidden(params, tokens=batch.get("tokens"), embeds=batch.get("embeds"))
        ce = cross_entropy(model.logits(params, h), batch["labels"])
        loss = ce + cfg.router_aux_weight * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp:
            mtp = _mtp_loss(model, params, h, batch)
            loss = loss + 0.3 * mtp
            metrics["mtp"] = mtp
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        flat = flatten(params)
        leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten(leaves), batch)
            # a leaf the loss does not reach gets zeros, as under jax.grad
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                        materialize_grads=True)
        # the gradient sync of sharded (DTensor) parameters: each gradient,
        # partial over the axes its parameter is replicated on, is reduced
        # once to its parameter's placements
        grads = [g.redistribute(placements=p.placements) if hasattr(p, "placements") else g
                 for g, p in zip(grads, leaves.values())]
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, gnorm = adamw.update(
            opt_cfg, unflatten(dict(zip(flat, grads))), opt_state, params)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step
