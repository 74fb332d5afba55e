"""Seeded weights in the port's parameter layout, made on the device.

A family's tree is its layout, ``layouts/<arch_type>.py``, found by the
config's ``arch_type``: an ordered list of :class:`Group`.  Each group has
a key prefix (``""`` for the top-level ``embed``, ``head``,
``final_norm``; ``dense_0``, ``shared_attn``, ``layers``, ...), a row
count (None: unstacked; n: stacked along a leading axis of n, the
layout's own count) and its leaves in ``(key, shape, kind, std)`` form.

Every slice is drawn from its own ``torch.Generator``, seeded from
``(seed, key, layer)``, so the harness can fill whole stacked tensors and
the reference can make any one slice again, bit for bit, without the
rest.  The seed rule, by group:

- top level (prefix ``""``): ``(seed, key, -1)``;
- ``layers`` row i: ``(seed, key relative to layers/, i)``;
- any other unstacked group: ``(seed, full path, -1)``;
- any other stack, row i: ``(seed, full path, i)``.

Full paths hold a ``/`` and top-level keys do not; :func:`layout` also
refuses a layout that gives two leaves one seed key, so no seed repeats,
and :func:`leaf` takes any slice by its ``(key, layer)``.  Only torch is
imported here: the reference uses this module too.

Scales follow the port's initializer (normal leaves at ``1/sqrt(fan_in)``,
the embedding at 0.02); the norms, the SSM's ``A_log``, ``dt_bias``,
``D`` and the conv bias are drawn around their initial values, as a
trained model's are, so that a path that ignored one of them would show
in the logits.
"""

from __future__ import annotations

import hashlib
import importlib
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

# (key, per-layer shape, kind, std); kind in normal | norm | a_log | dt_bias
# | d_skip | bias
Leaf = Tuple[str, Tuple[int, ...], str, float]


class Group(NamedTuple):
    prefix: str  # "" for the top-level leaves
    rows: Optional[int]  # None: unstacked; n: stacked along a leading axis
    leaves: List[Leaf]  # keys relative to the prefix


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


def _seed_key(prefix: str, key: str) -> str:
    return key if prefix in ("", "layers") else f"{prefix}/{key}"


def layout(cfg: Dict) -> List[Group]:
    """The groups of ``cfg``'s family (``layouts/<arch_type>.py``), each
    leaf's seed key checked to be its own."""
    arch = cfg["arch_type"]
    name = f"servebench.layouts.{arch}"
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no weight layout for arch_type {arch!r}: "
                         f"servebench/layouts/{arch}.py is missing") from None
    groups = mod.groups(cfg)
    seen = set()
    for g in groups:
        for key, *_ in g.leaves:
            k = _seed_key(g.prefix, key)
            if k in seen:
                raise ValueError(f"layout {arch!r} gives two leaves the seed key {k!r}")
            seen.add(k)
    return groups


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
    """One slice by its seed's ``(key, layer)`` (module docstring): a
    top-level leaf, row ``layer`` of a ``layers/`` leaf (key relative to
    ``layers/``), an unstacked group's leaf by its full path, or row
    ``layer`` of another stack's; drawn in bfloat16, returned as ``dtype``."""
    table = {_seed_key(g.prefix, lf[0]): (g, lf) for g in layout(cfg) for lf in g.leaves}
    g, (_, shape, kind, std) = table[key]
    if not (layer == -1 if g.rows is None else 0 <= layer < g.rows):
        raise IndexError(f"{key!r} has no row {layer} (group {g.prefix!r}, rows {g.rows})")
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
    """The whole parameter tree in bfloat16 on ``device``, group by group:
    each stacked leaf is allocated once and filled row by row."""
    flat: Dict[str, torch.Tensor] = {}
    for g in layout(cfg):
        for key, shape, kind, std in g.leaves:
            sk = _seed_key(g.prefix, key)
            path = f"{g.prefix}/{key}" if g.prefix else key
            if g.rows is None:
                flat[path] = fill(torch.empty(shape, dtype=torch.bfloat16, device=device),
                                  kind, std, seed, sk, -1)
                continue
            arr = torch.empty((g.rows,) + shape, dtype=torch.bfloat16, device=device)
            for i in range(g.rows):
                fill(arr[i], kind, std, seed, sk, i)
            flat[path] = arr
    return _unflatten(flat)


def nbytes(cfg: Dict) -> int:
    """Bytes of the bfloat16 parameter tree."""
    return 2 * sum((1 if g.rows is None else g.rows) * sum(math.prod(s) for _, s, _, _ in g.leaves)
                   for g in layout(cfg))


def iter_group(cfg: Dict, seed: int, prefix: str, row: int, dtype,
               device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Row ``row`` (-1 for an unstacked group) of group ``prefix``: each
    leaf's key relative to the prefix, and its slice as ``dtype``."""
    (g,) = [g for g in layout(cfg) if g.prefix == prefix]
    for key, *_ in g.leaves:
        yield key, leaf(cfg, seed, _seed_key(prefix, key), row, dtype, device)


def iter_layer(cfg: Dict, seed: int, layer: int, dtype, device) -> Iterator[Tuple[str, torch.Tensor]]:
    return iter_group(cfg, seed, "layers", layer, dtype, device)
