"""Pieces every family's reference shares: the norm, the products in each
precision, the embedding and the head."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from servebench import weights

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor, back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return fp8(x) @ fp8(w)
    return x @ w


def layer(cfg: Dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights, made again from the seed, in float32."""
    return dict(weights.iter_layer(cfg, seed, i, torch.float32, device))


def embed(cfg: Dict, seed: int, seqs: Sequence[torch.Tensor], precisions, device):
    table = weights.leaf(cfg, seed, "embed", dtype=torch.float32, device=device)
    xs = [table[s.to(device)] for s in seqs]
    del table
    return {p: [x.clone() for x in xs] for p in precisions}


def head(cfg: Dict, seed: int, streams, starts: Sequence[int], device) -> Dict[str, List[torch.Tensor]]:
    """Final norm and head over the positions asked for, the padding ids cut."""
    norm = weights.leaf(cfg, seed, "final_norm", dtype=torch.float32, device=device)
    w = weights.leaf(cfg, seed, "head", dtype=torch.float32, device=device)[:, :cfg["vocab_size"]]
    eps = cfg["norm_eps"]
    return {p: [matmul(rms(x[s:], norm, eps), w, p) for x, s in zip(xs, starts)]
            for p, xs in streams.items()}
