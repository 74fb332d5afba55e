"""Seeded weights in the port's parameter layout, made on the device.

Every (leaf, layer) slice is drawn from its own ``torch.Generator``, seeded
from ``(seed, key, layer)``, so the harness can fill whole stacked tensors
and the reference can make any one layer again, bit for bit, without the
rest.  Only torch is imported here: the reference uses this module too.

Leaves follow the port's key tree (``embed``, ``head``, ``final_norm``,
``layers/...`` stacked over a leading layer axis).  Scales follow its
initializer (normal leaves at ``1/sqrt(fan_in)``, the embedding at 0.02);
the norms, the SSM's ``A_log``, ``dt_bias``, ``D`` and the conv bias are
drawn around their initial values, as a trained model's are, so that a
path that ignored one of them would show in the logits.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

# (key, per-layer shape, kind, std); kind in normal | norm | a_log | dt_bias
# | d_skip | bias
Leaf = Tuple[str, Tuple[int, ...], str, float]


def padded_vocab(cfg: Dict) -> int:
    p = cfg.get("vocab_pad", 256)
    return -(-cfg["vocab_size"] // p) * p


def d_inner(cfg: Dict) -> int:
    return cfg.get("ssm_expand", 2) * cfg["d_model"]


def ssm_heads(cfg: Dict) -> int:
    return d_inner(cfg) // cfg.get("ssm_head_dim", 64)


def _normal(key: str, shape: Tuple[int, ...], std: float = 0.0) -> Leaf:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return key, shape, "normal", std or 1.0 / math.sqrt(fan_in)


def top_leaves(cfg: Dict) -> List[Leaf]:
    d, vp = cfg["d_model"], padded_vocab(cfg)
    return [_normal("embed", (vp, d), 0.02), _normal("head", (d, vp)),
            ("final_norm", (d,), "norm", 0.1)]


def layer_leaves(cfg: Dict) -> List[Leaf]:
    """The leaves of one stacked layer, keys relative to ``layers/``."""
    d = cfg["d_model"]
    if cfg["arch_type"] == "dense":
        H, KV = cfg["num_heads"], cfg["num_kv_heads"]
        hd = cfg.get("head_dim") or d // H
        ff = cfg["d_ff"]
        out = [("ln1", (d,), "norm", 0.1),
               _normal("attn/wq", (d, H * hd)), _normal("attn/wk", (d, KV * hd)),
               _normal("attn/wv", (d, KV * hd)), _normal("attn/wo", (H * hd, d))]
        if cfg.get("qk_norm"):
            out += [("attn/q_norm", (hd,), "norm", 0.1), ("attn/k_norm", (hd,), "norm", 0.1)]
        out.append(("ln2", (d,), "norm", 0.1))
        if cfg.get("mlp_gated", True):
            out.append(_normal("mlp/w_gate", (d, ff)))
        return out + [_normal("mlp/w_up", (d, ff)), _normal("mlp/w_down", (ff, d))]
    if cfg["arch_type"] == "ssm":
        di, n, H = d_inner(cfg), cfg["ssm_state"], ssm_heads(cfg)
        conv_ch = di + 2 * n
        W = cfg.get("conv_width", 4)
        return [("ln", (d,), "norm", 0.1),
                _normal("w_z", (d, di)), _normal("w_xbc", (d, conv_ch)), _normal("w_dt", (d, H)),
                _normal("conv_w", (W, conv_ch)), ("conv_b", (conv_ch,), "bias", 0.1),
                ("A_log", (H,), "a_log", 0.0), ("dt_bias", (H,), "dt_bias", 0.0),
                ("D", (H,), "d_skip", 0.1), ("ssm_norm", (di,), "norm", 0.1),
                _normal("w_out", (di, d))]
    raise ValueError(f"no weight layout for arch_type {cfg['arch_type']!r}")


def _seed(seed: int, key: str, layer: int) -> int:
    h = hashlib.sha256(f"{seed}/{key}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def fill(out: torch.Tensor, kind: str, std: float, seed: int, key: str, layer: int) -> torch.Tensor:
    """Draw one slice into ``out`` (any float dtype) in place."""
    gen = torch.Generator(device=out.device)
    gen.manual_seed(_seed(seed, key, layer))
    if kind in ("normal", "bias"):
        return out.normal_(0.0, std, generator=gen)
    if kind in ("norm", "d_skip"):
        return out.normal_(1.0, std, generator=gen)
    u = torch.rand(out.shape, generator=gen, device=out.device, dtype=torch.float32)
    if kind == "a_log":  # A = -exp(A_log) uniform on [-16, -1], Mamba2's initial range
        vals = torch.log(1.0 + 15.0 * u)
    elif kind == "dt_bias":  # softplus(dt_bias) log-uniform on [1e-3, 1e-1]
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        vals = dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown leaf kind {kind!r}")
    return out.copy_(vals)


def leaf(cfg: Dict, seed: int, key: str, layer: int = -1, dtype=torch.bfloat16,
         device="cpu") -> torch.Tensor:
    """One leaf (``layer`` -1: a top-level one) or one layer's slice of a
    stacked leaf, drawn in bfloat16 and returned as ``dtype``."""
    table = {k: (s, kind, std) for k, s, kind, std in
             (top_leaves(cfg) if layer < 0 else layer_leaves(cfg))}
    shape, kind, std = table[key]
    t = fill(torch.empty(shape, dtype=torch.bfloat16, device=device), kind, std, seed, key, layer)
    return t.to(dtype)


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for key, val in flat.items():
        node = out
        *parents, name = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = val
    return out


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The whole parameter tree in bfloat16 on ``device``: each stacked
    leaf is allocated once and filled layer by layer."""
    flat: Dict[str, torch.Tensor] = {}
    for key, shape, kind, std in top_leaves(cfg):
        flat[key] = fill(torch.empty(shape, dtype=torch.bfloat16, device=device),
                         kind, std, seed, key, -1)
    n = cfg["num_layers"]
    for key, shape, kind, std in layer_leaves(cfg):
        arr = torch.empty((n,) + shape, dtype=torch.bfloat16, device=device)
        for i in range(n):
            fill(arr[i], kind, std, seed, key, i)
        flat[f"layers/{key}"] = arr
    return _unflatten(flat)


def nbytes(cfg: Dict) -> int:
    """Bytes of the bfloat16 parameter tree."""
    n = cfg["num_layers"]
    tot = sum(math.prod(s) for _, s, _, _ in top_leaves(cfg))
    tot += n * sum(math.prod(s) for _, s, _, _ in layer_leaves(cfg))
    return 2 * tot


def iter_layer(cfg: Dict, seed: int, layer: int, dtype, device) -> Iterator[Tuple[str, torch.Tensor]]:
    for key, *_ in layer_leaves(cfg):
        yield key, leaf(cfg, seed, key, layer, dtype, device)
