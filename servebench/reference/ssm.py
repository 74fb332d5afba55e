"""Plain reference of the port's Mamba2 decoder (``arch_type`` ssm).

Per layer, pre-norm: h = RMSNorm(x)·ln; z = h·Wz, xBC = h·Wxbc, dt = h·Wdt;
xBC = SiLU(causal depthwise conv of width W over xBC, + bias); split into
x (heads of P), B and C (one group of N); dt = softplus(dt + dt_bias);
A = -exp(A_log).  The SSD recurrence s_t = exp(dt_t·A)·s_{t-1} +
dt_t·x_t⊗B_t, y_t = C_t·s_t, is computed here in its quadratic (dual)
form over the whole sequence, y_t = Σ_{s≤t} (C_t·B_s)·exp(Σ_{s<r≤t}
dt_r·A)·dt_s·x_s, a different algorithm from the port's chunked scan and
state steps.  Then y += D·x; y = RMSNorm(y·SiLU(z))·ssm_norm; x += y·Wout.
Logits as in the dense reference.  All float32.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from servebench.reference.common import embed, head, layer, matmul, rms


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor) -> torch.Tensor:
    """x (S, H, P), dt (S, H), A (H,), B/C (S, N) -> y (S, H, P)."""
    S = x.shape[0]
    cs = torch.cumsum(dt * A, dim=0)  # (S, H), inclusive
    seg = (cs[:, None, :] - cs[None, :, :]).permute(2, 0, 1)  # (H, t, s)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, -torch.inf))
    m = (C @ B.T)[None] * decay * dt.T[:, None, :]  # (H, t, s)
    return (m @ x.permute(1, 0, 2)).permute(1, 0, 2)


def block(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor, prec: str) -> torch.Tensor:
    d, n = cfg["d_model"], cfg["ssm_state"]
    di = cfg["ssm_expand"] * d
    P = cfg["ssm_head_dim"]
    H = di // P
    eps = cfg["norm_eps"]
    S = x.shape[0]
    h = rms(x, w["ln"], eps)
    z = matmul(h, w["w_z"], prec)
    xbc = matmul(h, w["w_xbc"], prec)
    dt = matmul(h, w["w_dt"], prec)
    conv_w = w["conv_w"]  # (W, channels)
    W = conv_w.shape[0]
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = F.silu(sum(padded[j:j + S] * conv_w[j] for j in range(W)) + w["conv_b"])
    xs = xbc[:, :di].reshape(S, H, P)
    B, C = xbc[:, di:di + n], xbc[:, di + n:]
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    y = ssd(xs, dt, A, B, C) + w["D"][None, :, None] * xs
    y = rms(y.reshape(S, di) * F.silu(z), w["ssm_norm"], eps)
    return x + matmul(y, w["w_out"], prec)


def logits(cfg: Dict, seed: int, seqs: Sequence[torch.Tensor], starts: Sequence[int],
           device, precisions):
    streams = embed(cfg, seed, seqs, precisions, device)
    for i in range(cfg["num_layers"]):
        w = layer(cfg, seed, i, device)
        for p, xs in streams.items():
            streams[p] = [block(cfg, w, x, p) for x in xs]
        del w
    return head(cfg, seed, streams, starts, device)
