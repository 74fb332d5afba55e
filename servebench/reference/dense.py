"""Plain reference of the port's dense decoder (``arch_type`` dense).

Per layer, pre-norm: h = RMSNorm(x)·ln1; q, k, v = h·Wq, h·Wk, h·Wv split
into heads (the k/v heads shared by groups of query heads); split-half
RoPE at ``rope_theta`` on q and k; causal softmax(q·kᵀ/√hd)·v; x += o·Wo;
then x += MLP(RMSNorm(x)·ln2), GELU (tanh form) of h·Wup then ·Wdown, or
SwiGLU where ``mlp_gated``.  Logits: RMSNorm(x)·final_norm · head, the
vocabulary's padding cut.  All float32; attention in blocks of query rows.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from servebench.reference.common import embed, head, layer, matmul, rms

Q_BLOCK = 1024  # query rows a score block holds


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of (S, heads, hd) at positions 0..S-1."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention; q (S, H, hd), k/v (S, KV, hd) -> (S, H·hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(S, KV, G, hd).permute(1, 2, 0, 3)  # (KV, G, S, hd)
    kt = k.permute(1, 2, 0)  # (KV, hd, S)
    vt = v.permute(1, 0, 2)  # (KV, S, hd)
    out = torch.empty((KV, G, S, hd), dtype=q.dtype, device=q.device)
    cols = torch.arange(S, device=q.device)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        s = (qg[:, :, a:b] @ kt[:, None]) / math.sqrt(hd)  # (KV, G, rows, S)
        s = s.masked_fill(cols[None, :] > torch.arange(a, b, device=q.device)[:, None], -math.inf)
        out[:, :, a:b] = torch.softmax(s, dim=-1) @ vt[:, None]
    return out.permute(2, 0, 1, 3).reshape(S, H * hd)


def block(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor, prec: str) -> torch.Tensor:
    d, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    eps = cfg["norm_eps"]
    S = x.shape[0]
    h = rms(x, w["ln1"], eps)
    q = matmul(h, w["attn/wq"], prec).reshape(S, H, hd)
    k = matmul(h, w["attn/wk"], prec).reshape(S, KV, hd)
    v = matmul(h, w["attn/wv"], prec).reshape(S, KV, hd)
    if cfg.get("qk_norm"):
        q, k = rms(q, w["attn/q_norm"], eps), rms(k, w["attn/k_norm"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    x = x + matmul(attention(q, k, v), w["attn/wo"], prec)
    h = rms(x, w["ln2"], eps)
    if cfg.get("mlp_gated", True):
        m = F.silu(matmul(h, w["mlp/w_gate"], prec)) * matmul(h, w["mlp/w_up"], prec)
    else:
        m = F.gelu(matmul(h, w["mlp/w_up"], prec), approximate="tanh")
    return x + matmul(m, w["mlp/w_down"], prec)


def logits(cfg: Dict, seed: int, seqs: Sequence[torch.Tensor], starts: Sequence[int],
           device, precisions):
    streams = embed(cfg, seed, seqs, precisions, device)
    for i in range(cfg["num_layers"]):
        w = layer(cfg, seed, i, device)
        for p, xs in streams.items():
            streams[p] = [block(cfg, w, x, p) for x in xs]
        del w
    return head(cfg, seed, streams, starts, device)
