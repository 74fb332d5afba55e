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

# one entry a dimension: the mesh axis (or tuple of axes) that shards it, or
# None (the JAX ``PartitionSpec``)
PartitionSpec = Tuple[Union[None, str, Tuple[str, ...]], ...]
# flat key path -> (shape, init, scale, partition spec); init in
# {"normal", "ones", "zeros"}
ParamSpec = Tuple[Tuple[int, ...], str, Optional[float], PartitionSpec]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without it raises: nothing falls back to the CPU silently.  Under a
    ``FakeTensorMode`` (the dry run) nothing is allocated, so fake CUDA
    tensors need no card."""
    dev = torch.device(device)
    if (dev.type == "cuda" and not torch.cuda.is_available()
            and torch._guards.detect_fake_mode() is None):
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
    for name, (shape, init, scale, _) in specs.items():
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


def batch_spec(mesh_axes: Tuple[str, ...]) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod','data') on a multi-pod mesh, ('data',)
    on a single pod."""
    return tuple(a for a in mesh_axes if a in ("pod", "data"))


# -- sharded (DTensor) tensors: the dry run's ------------------------------------


def is_dtensor(t: Any) -> bool:
    return hasattr(t, "device_mesh")


def _as_dtensor(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def shard_span(n: int, mesh, placements, dim: int = 0) -> Tuple[int, int]:
    """(start, length) of this rank's shard of a dimension ``dim`` of size
    ``n`` under ``placements``: the mesh axes that shard it split it in
    turn, in even chunks (DTensor's layout)."""
    start, size = 0, n
    for axis, (p, c) in enumerate(zip(placements, mesh.get_coordinate())):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(axis))
            start += c * chunk
            size = max(0, min(chunk, size - c * chunk))
    return start, size


def _shard_offset(t, dim: int) -> int:
    """Where this rank's shard of DTensor ``t`` starts along ``dim``."""
    return shard_span(t.shape[dim], t.device_mesh, t.placements, dim)[0]


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A DTensor table sharded over its rows (the
    vocabulary) is looked up shard by shard: each shard looks up the ids
    among its own rows and gives zeros for the rest, and the partial sums
    are reduced (:func:`settle`)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    ids = _as_dtensor(ids, mesh)
    ids_pl, out_pl = [], []
    for p, q in zip(table.placements, ids.placements):
        if p == Shard(0):
            ids_pl.append(Replicate())
            out_pl.append(Partial())
        elif p == Shard(1):
            ids_pl.append(Replicate())
            out_pl.append(Shard(ids.ndim))
        else:
            ids_pl.append(q)
            out_pl.append(q)
    r0 = _shard_offset(table, 0)

    def lookup(t, i):
        j = i - r0
        ok = (j >= 0) & (j < t.shape[0])
        return (torch.nn.functional.embedding(j.clamp(0, t.shape[0] - 1), t)
                * ok[..., None].to(t.dtype))

    return settle(local_map(lookup, out_placements=(tuple(out_pl),),
                            in_placements=(tuple(table.placements), tuple(ids_pl)),
                            device_mesh=mesh, redistribute_inputs=True)(table, ids))


def write_rows(cache: torch.Tensor, new: torch.Tensor, live: torch.Tensor,
               idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode step's cache write, in place, for the slots the ``(B,)``
    bool mask ``live`` marks: ``cache[b, idx[b]] = new[b, 0]`` (a row at a
    position per slot), or without ``idx`` ``cache[b] = new[b]`` (a slot's
    whole entry).

    Every slot writes, at fixed shapes, and nothing looks up which slots
    are live, so a step never waits for the device and a CUDA graph can
    hold it: an idle slot's row is written back with its own value, as the
    reference's ``jnp.where`` does (the paged pools send idle slots to a
    sink page instead).  A DTensor cache is written shard by shard, each
    shard keeping the positions that fall in its rows."""
    if not is_dtensor(cache):
        _write_masked(cache, new, live, idx)
        return cache
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = cache.device_mesh
    cache_pl = tuple(cache.placements)
    new_pl = tuple(Replicate() if idx is not None and p == Shard(1) else p for p in cache_pl)
    slot_pl = tuple(p if p == Shard(0) else Replicate() for p in cache_pl)
    if idx is None:
        local_map(_write_masked, out_placements=None, in_placements=(cache_pl, new_pl, slot_pl),
                  device_mesh=mesh, redistribute_inputs=True)(
            cache, _as_dtensor(new, mesh), _as_dtensor(live, mesh))
        return cache
    s0 = _shard_offset(cache, 1)

    def write_at(c, n, ok, i):
        j = i - s0
        ok = ok & (j >= 0) & (j < c.shape[1])
        _write_masked(c, n, ok, j.clamp(0, c.shape[1] - 1))

    local_map(write_at, out_placements=None,
              in_placements=(cache_pl, new_pl, slot_pl, slot_pl),
              device_mesh=mesh, redistribute_inputs=True)(
        cache, _as_dtensor(new, mesh), _as_dtensor(live, mesh), _as_dtensor(idx, mesh))
    return cache


def _write_masked(c: torch.Tensor, n: torch.Tensor, live: torch.Tensor,
                  idx: Optional[torch.Tensor] = None) -> None:
    """:func:`write_rows` on plain tensors."""
    if idx is None:
        torch.where(live.view((-1,) + (1,) * (c.dim() - 1)), n, c, out=c)
        return
    b = torch.arange(c.shape[0], device=c.device)
    cur = c[b, idx]
    c[b, idx] = torch.where(live.view((-1,) + (1,) * (cur.dim() - 1)), n[:, 0], cur)


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``t`` (..., heads * head_dim) as (..., heads, head_dim).  A DTensor
    sharded over its last dimension on an axis that does not divide
    ``heads`` is gathered over that axis first: DTensor splits a sharded
    dimension only where each shard holds whole heads."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate

        last = t.ndim - 1
        pl = [Replicate() if p.is_shard(last) and heads % t.device_mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(placements=pl)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def placements(spec: PartitionSpec, mesh) -> list:
    """A partition spec as DTensor placements on ``mesh``: each mesh axis
    shards the tensor dimension whose entry names it, or replicates."""
    from torch.distributed.tensor import Replicate, Shard

    def names(entry):
        return entry if isinstance(entry, tuple) else (entry,)

    return [next((Shard(i) for i, e in enumerate(spec) if axis in names(e)), Replicate())
            for axis in mesh.mesh_dim_names]


def constrain(t: torch.Tensor, spec: Optional[PartitionSpec]) -> torch.Tensor:
    """A DTensor ``t`` redistributed to the partition spec ``spec`` (the
    reference's ``with_sharding_constraint``; partial sums are reduced, and
    scattered where the spec shards a dimension); plain tensors, and any
    tensor when ``spec`` is None, pass as they are."""
    if spec is None or not is_dtensor(t):
        return t
    pl = placements(spec, t.device_mesh)
    return t if pl == list(t.placements) else t.redistribute(placements=pl)


def settle(t: torch.Tensor) -> torch.Tensor:
    """A sublayer's output as the residual stream holds it: a DTensor keeps
    its batch sharding and is made whole on every other axis (partial sums
    reduced: the tensor-parallel all-reduce).  Plain tensors pass as they
    are."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    pl = [p if p == Shard(0) else Replicate() for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(placements=pl)
