"""Shared model components: dtypes, devices, norms, RoPE, seeded init.

Parameters are plain nested dicts of tensors with the JAX package's key
tree (``embed``, ``layers/attn/wq``, ...), so the weight bridge
(:mod:`repro_torch.bridge`) maps one onto the other by key path.  Stacked
per-layer parameters carry a leading layer axis, as the JAX stacks do for
``scan``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# flat key path -> (shape, init, scale); init in {"normal", "ones", "zeros"}
ParamSpec = Tuple[Tuple[int, ...], str, Optional[float]]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without it raises: nothing falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


# -- seeded initializer (the port's ParamFactory) -------------------------------


def init_params(
    specs: Dict[str, ParamSpec],
    seed: int,
    device: torch.device,
    dtype: torch.dtype,
    stacked: Sequence[str] = ("layers",),
) -> Dict[str, Any]:
    """Create parameters from ``specs`` with a ``torch.Generator`` seeded by
    ``seed`` on ``device``.  Same shapes and scales as the JAX
    ``ParamFactory`` (normal leaves draw N(0, 1) in float32 times
    ``scale`` or ``1/sqrt(fan_in)``, then cast); the numbers differ from
    JAX's PRNG, so parity tests bridge JAX weights instead.  Leaves under a
    ``stacked`` prefix are drawn one layer at a time, which bounds the
    float32 temporary at one layer's worth."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat: Dict[str, torch.Tensor] = {}
    for name, (shape, init, scale) in specs.items():
        if init == "ones":
            flat[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        if init == "zeros":
            flat[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if init != "normal":
            raise ValueError(f"{name}: unknown init {init!r}")
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
        if name.split("/")[0] in stacked:
            arr = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                arr[i] = _normal(shape[1:], std, gen, device).to(dtype)
        else:
            arr = _normal(shape, std, gen, device).to(dtype)
        flat[name] = arr
    return unflatten(flat)


def _normal(shape, std, gen, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` (the ``/``-joined key paths of
    the JAX checkpoint layout)."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def tree_to(tree: Dict[str, Any], device: Union[str, torch.device]) -> Dict[str, Any]:
    """Copy every tensor of a nested dict to ``device``."""
    return {
        k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }


# -- norms ---------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """As the JAX package computes it: normalise in float32, cast back to
    ``x``'s dtype, then scale by ``w``."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


# -- rotary embeddings ------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE.  x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
