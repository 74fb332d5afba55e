"""Mamba2 (SSD, state-space duality) block.  [arXiv:2405.21060]

The port of the JAX package's ``models/ssm.py``, without its sharding
specs.  Prefill runs the chunked SSD algorithm: quadratic attention-like
work inside chunks of ``ssm_chunk`` steps, a linear recurrence across
them.  Decode keeps the (B, H, P, N) float32 state plus the raw tail of
the depthwise conv.

Prefill's scan goes through :func:`repro_torch.models.kernels_bridge.ssm_scan`
(the CUDA kernel on a card, its plain version on the CPU); the JAX package
calls its jnp ``ssd_chunked`` there.  Decode updates the cache in place;
the functions still return it, as the reference's do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.models import kernels_bridge
from repro_torch.models.common import (
    ParamSpec, PartitionSpec, rmsnorm, split_heads, write_rows,
)
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The key tree and shapes of the JAX ``ssm_init``."""
    d, di, n, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        "w_z": ((d, di), "normal", None, (None, "model")),
        "w_xbc": ((d, conv_ch), "normal", None, (None, "model")),
        "w_dt": ((d, H), "normal", None, (None, "model")),
        "conv_w": ((cfg.conv_width, conv_ch), "normal", None, (None, "model")),
        "conv_b": ((conv_ch,), "zeros", None, ("model",)),
        "A_log": ((H,), "zeros", None, (None,)),
        "dt_bias": ((H,), "zeros", None, (None,)),
        "D": ((H,), "ones", None, (None,)),
        "ssm_norm": ((di,), "ones", None, ("model",)),
        "w_out": ((di, d), "normal", None, ("model", None)),
    }


def _project(p: Params, x: torch.Tensor):
    """(z, xBC, dt) input projections."""
    return x @ p["w_z"], x @ p["w_xbc"], x @ p["w_dt"]


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C)."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(out + b)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch; returns (y, final_state (B,H,P,N)).
    One body with the scan kernel's plain version."""
    return ssm_scan_plain(x, dt, A, B_, C_, chunk)


def ssd_step(
    state: torch.Tensor,  # (B, H, P, N)
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_t: torch.Tensor,  # (B, N)
    C_t: torch.Tensor,  # (B, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step; returns (y_t (B,H,P), new_state)."""
    dA = torch.exp(torch.clamp(dt_t * A[None, :], -60.0, 0.0))  # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt_t, x_t, B_t)
    new_state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C_t, new_state)
    return y, new_state


# -- block-level forward / prefill / decode -------------------------------------


def _mix(
    p: Params, cfg: ModelConfig, x: torch.Tensor, lengths: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over a full sequence: (output, final SSD state, raw xBC)."""
    B, S, _ = x.shape
    di, n, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_raw, dt = _project(p, x)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs = split_heads(xBC[..., :di], H, hd)
    B_ = xBC[..., di:di + n]
    C_ = xBC[..., di + n:]
    dt_ = F.softplus(dt.float() + p["dt_bias"])
    if lengths is not None:
        # padded steps get dt = 0: an exact identity step of the recurrence
        pad_mask = torch.arange(S, device=x.device)[None, :] < lengths[:, None]  # (B, S)
        dt_ = dt_ * pad_mask[:, :, None]
    A = -torch.exp(p["A_log"].float())
    y, final = kernels_bridge.ssm_scan(
        xs.float(), dt_, A, B_.float(), C_.float(), cfg.ssm_chunk
    )
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return y @ p["w_out"], final, xBC_raw


def ssm_forward(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _mix(p, cfg, x, None)[0]


def ssm_prefill(
    p: Params, cfg: ModelConfig, x: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # (B,) true lengths of padded rows
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like :func:`ssm_forward` but also emits the decode cache (final SSD
    state + raw conv tail).

    ``lengths`` supports right-padded ragged prefill (the serving engine
    pads prompts up to ``ssm_chunk``): padded steps get ``dt = 0``, so the
    final state equals the state after ``lengths`` real tokens; the conv
    tail is taken per row at ``lengths`` (zero-left-padded, matching the
    zero conv init for prompts shorter than the kernel)."""
    out, final, xBC_raw = _mix(p, cfg, x, lengths)
    B, S, _ = xBC_raw.shape
    W1 = cfg.conv_width - 1
    if lengths is None:
        conv = xBC_raw[:, S - W1:]
    else:
        padded = F.pad(xBC_raw, (0, 0, W1, 0))
        # row b's window [lengths[b], lengths[b] + W1) of the padded input,
        # gathered on the device (no host round trip per layer)
        idx = lengths.long()[:, None] + torch.arange(W1, device=x.device)[None, :]
        conv = padded[torch.arange(B, device=x.device)[:, None], idx]
    return out, {"conv": conv, "state": final}


def ssm_init_cache(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device: torch.device
) -> Dict[str, torch.Tensor]:
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n), dtype=dtype, device=device),
        "state": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, n), dtype=torch.float32, device=device
        ),
    }


def ssm_cache_specs(cfg: ModelConfig, dp: Tuple[str, ...]) -> Dict[str, PartitionSpec]:
    """Partition specs of the decode cache: the conv tail's channels and the
    state's heads over "model" (as ``w_xbc`` is sharded)."""
    return {"conv": (dp, None, "model"), "state": (dp, "model", None, None)}


def ssm_decode(
    p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Dict[str, torch.Tensor],
    live: torch.Tensor,  # (B,) bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step, x: (B, 1, d).  The cache is updated in place: idle
    slots keep their conv tail and state (:func:`write_rows`)."""
    B = x.shape[0]
    di, n, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _project(p, x)  # (B,1,·)
    hist = torch.cat([cache["conv"], xBC], dim=1)  # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    xBC1 = F.silu(conv_out)  # (B,C)
    xs = split_heads(xBC1[:, :di], H, hd)
    B_ = xBC1[:, di:di + n]
    C_ = xBC1[:, di + n:]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"].float())
    y, new_state = ssd_step(
        cache["state"], xs.float(), dt1, A, B_.float(), C_.float()
    )
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    write_rows(cache["conv"], hist[:, 1:], live)
    write_rows(cache["state"], new_state, live)
    return y @ p["w_out"], cache
