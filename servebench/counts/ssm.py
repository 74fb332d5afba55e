"""A Mamba2 (SSD) decoder's admission and decode step (``arch_type`` ssm):
(flops by precision, bytes), each weight read once."""

from __future__ import annotations

from typing import Dict, Sequence

from servebench.counts import kernels


def _dims(cfg: Dict):
    d = cfg["d_model"]
    di = cfg.get("ssm_expand", 2) * d
    P = cfg.get("ssm_head_dim", 64)
    return d, di, cfg["ssm_state"], di // P, P, cfg.get("conv_width", 4)


def layer_params(cfg: Dict) -> int:
    """The four projections: z, xBC, dt in; out."""
    d, di, n, H, _, _ = _dims(cfg)
    return d * (di + di + 2 * n + H) + di * d


def weight_bytes(cfg: Dict) -> float:
    d, di, n, H, _, W = _dims(cfg)
    small = (di + 2 * n) * (W + 1) + 3 * H + di + d
    return 2.0 * (cfg["num_layers"] * (layer_params(cfg) + small)
                  + d * cfg["vocab_size"] + d)


def state_bytes(cfg: Dict) -> float:
    """One slot's decode state over every layer: the float32 (H, P, N)
    state and the bf16 conv tail."""
    d, di, n, H, P, W = _dims(cfg)
    return cfg["num_layers"] * (4.0 * H * P * n + 2.0 * (W - 1) * (di + 2 * n))


def prefill(cfg: Dict, L: int) -> kernels.Work:
    """An admission of an ``L``-token prompt: projections and conv over L
    tokens, the chunked scan (TF32), the head over the last token; weights
    and L embedding rows read, the state and one row of logits written."""
    d, di, n, H, P, W = _dims(cfg)
    scan_flops, _ = kernels.ssm_scan(L, H, P, n, cfg.get("ssm_chunk", 128))
    per_layer = 2.0 * L * (layer_params(cfg) + (di + 2 * n) * W)
    bf16 = per_layer * cfg["num_layers"] + 2.0 * d * cfg["vocab_size"]
    nbytes = weight_bytes(cfg) + 2.0 * L * d + state_bytes(cfg) + 2.0 * cfg["vocab_size"]
    return {"bf16": bf16, "tf32": scan_flops["tf32"] * cfg["num_layers"]}, nbytes


def decode(cfg: Dict, lens: Sequence[int]) -> kernels.Work:
    """One decode step of ``len(lens)`` live slots: projections, conv and
    the state update (4·H·P·N a slot a layer) and the head; weights read,
    every live slot's state read and written."""
    d, di, n, H, P, W = _dims(cfg)
    B = len(lens)
    per_layer = 2.0 * B * (layer_params(cfg) + (di + 2 * n) * W) + 4.0 * B * H * P * n
    flops = per_layer * cfg["num_layers"] + 2.0 * B * d * cfg["vocab_size"]
    nbytes = weight_bytes(cfg) + 2.0 * B * d + 2 * B * state_bytes(cfg) + 2.0 * B * cfg["vocab_size"]
    return {"bf16": flops}, nbytes
