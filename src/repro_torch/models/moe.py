"""Mixture-of-Experts layer (DeepSeek style: shared and routed experts, top-k).

The port of ``moe_init``, ``capacity`` and ``moe_forward`` of the JAX
package's ``models/moe.py``.  Dispatch is by capacity: each token's ``k``
assignments are placed, in arrival order over the flattened ``(T*k)``
assignments, into an ``(E, C, d)`` expert buffer; assignments past an
expert's ``C`` slots are dropped.  The expert SwiGLU is a batched product
over ``E``, and the outputs are gathered back and weighted by the
renormalised router probabilities.  The router runs in float32; the
Switch-style load-balance loss is returned beside the output.

A dropped assignment is parked at slot ``C-1`` with a zero weight, as in
the reference, and the buffer is filled by an accumulating
``index_put_``: each ``(expert, slot)`` then receives one real token plus
exact zeros, so the result does not depend on the order of the card's
atomic adds.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamSpec, PartitionSpec, is_dtensor, placements, shard_span,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_forward, mlp_specs


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    specs: Dict[str, ParamSpec] = {
        "router": ((d, E), "normal", 0.02, (None, None)),
        "we_gate": ((E, d, ff), "normal", None, ("model", None, None)),
        "we_up": ((E, d, ff), "normal", None, ("model", None, None)),
        "we_down": ((E, ff, d), "normal", None, ("model", None, None)),
    }
    if cfg.num_shared_experts:
        shared = mlp_specs(cfg, d_ff=ff * cfg.num_shared_experts)
        specs.update({f"shared/{k}": s for k, s in shared.items()})
    return specs


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``capacity_factor`` times the even share of the
    ``tokens * k`` assignments, rounded up to a multiple of 8, at least 8."""
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row, largest first, ties to the lower index
    (as ``jax.lax.top_k``; ``torch.topk`` promises no order among ties)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _experts(p: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU of an (E, C, d) buffer, batched over E."""
    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    return torch.bmm(h, p["we_down"])  # (E, C, d)


def _dispatch(
    p: Dict[str, torch.Tensor], cfg: ModelConfig, xf: torch.Tensor, lo: int, n_local: int,
    C: int, experts: Callable = _experts,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route the ``T`` tokens of ``xf`` (T, d) over all ``E`` experts and run
    the experts ``lo .. lo + n_local`` (whose weights ``p["we_*"]`` holds)
    at ``C`` slots each, by ``experts(p, buf)``; returns (their weighted
    output (T, d), the top-k indices (T, k), the router probabilities
    (T, E)).  With every expert (``lo`` 0, ``n_local`` E) the output is the
    layer's routed output."""
    T, d = xf.shape
    k = cfg.experts_per_token
    logits = xf.float() @ p["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)  # (T, k)
    w = w / w.sum(dim=-1, keepdim=True)  # DeepSeek renormalises the top-k

    idx_f = idx.reshape(T * k) - lo
    w_f = w.reshape(T * k).to(xf.dtype)
    mine = (idx_f >= 0) & (idx_f < n_local)
    safe_e = idx_f.clamp(0, n_local - 1)
    onehot = F.one_hot(safe_e, n_local) * mine[:, None]  # (T*k, n_local)
    pos_f = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)  # slot within expert
    keep = (mine & (pos_f < C)).to(xf.dtype)
    safe_pos = pos_f.clamp(max=C - 1)

    xk = xf[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((n_local, C, d), dtype=xf.dtype, device=xf.device)
    buf.index_put_((safe_e, safe_pos), xk * keep[:, None], accumulate=True)

    hout = experts(p, buf)  # (n_local, C, d)

    gathered = hout[safe_e, safe_pos] * (keep * w_f)[:, None]  # (T*k, d)
    return gathered.reshape(T, k, d).sum(dim=1), idx, probs


def _aux(idx: torch.Tensor, probs: torch.Tensor, E: int) -> torch.Tensor:
    """The Switch-style load-balance loss of one routing."""
    frac = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    return E * (frac * probs.mean(dim=0)).sum()


def moe_forward(
    p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
    buf_spec: Optional[PartitionSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss).  Every row takes part,
    idle decode rows included, as in the reference: they compete for
    capacity in arrival order.  A DTensor ``x`` (the dry run) computes
    the same function shard by shard (:func:`_moe_sharded`); ``buf_spec``
    places its (E, C, d) expert buffer (the reference's constraint:
    ``("model", "data", None)`` splits the capacity over "data").  Plain
    tensors ignore it."""
    if is_dtensor(x):
        return _moe_sharded(p, cfg, x, buf_spec)
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    out, idx, probs = _dispatch(p, cfg, xf, 0, cfg.num_experts, capacity(T, cfg))
    if cfg.num_shared_experts:
        out = out + mlp_forward(p["shared"], xf)
    return out.reshape(B, S, d), _aux(idx, probs, cfg.num_experts)


def _moe_sharded(p, cfg: ModelConfig, x, buf_spec: Optional[PartitionSpec] = None):
    """:func:`moe_forward` of DTensors, with the reference's dispatch: every
    device routes all ``B * S`` tokens at the global capacity (``x`` is
    gathered whole, since arrival order couples the tokens) and runs the
    experts of its shard over all of them; the shared experts are the
    tensor-parallel MLP.  The outputs are partial sums over the axes that
    shard the experts; each device keeps its own batch rows on the others.

    A ``buf_spec`` that shards the buffer's capacity (dim 1) over some axes
    runs each device's experts on its own slots only; their outputs are
    then all-gathered over those axes (the reference's XLA gathers them for
    the combine).  Its experts dim must be sharded as the weights are."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    B, S, d = x.shape
    T = B * S
    ep = [p["we_gate"].placements[a] == Shard(0) for a in range(mesh.ndim)]
    rep = (Replicate(),) * mesh.ndim
    experts = tuple(Shard(0) if e else Replicate() for e in ep)
    keys = ["router", "we_gate", "we_up", "we_down"]
    in_pl = [rep, rep, experts, experts, experts]  # x, router, experts
    if cfg.num_shared_experts:
        keys += ["shared/w_gate", "shared/w_up", "shared/w_down"]
        cols = tuple(Shard(1) if e else Replicate() for e in ep)
        in_pl += [cols, cols, experts]
    # the rows this device keeps: x's batch sharding on the axes not partial
    rows_pl = [Replicate() if e else pl for e, pl in zip(ep, x.placements)]
    r0, n_rows = shard_span(B, mesh, rows_pl)
    lo = shard_span(cfg.num_experts, mesh, experts)[0]
    C = capacity(T, cfg)
    cap_axes, c0, cn = [], 0, C
    if buf_spec is not None:
        buf_pl = placements(buf_spec, mesh)
        if [pl.is_shard(0) for pl in buf_pl] != ep:
            raise ValueError(f"expert buffer spec {buf_spec} must shard the experts as the "
                             f"weights do: {tuple(p['we_gate'].placements)}")
        cap_axes = [a for a, pl in enumerate(buf_pl) if pl.is_shard(1)]
        n_cap = math.prod(mesh.size(a) for a in cap_axes)
        if C % n_cap:
            raise ValueError(f"capacity {C} does not split over {n_cap} devices")
        c0, cn = shard_span(C, mesh, buf_pl, dim=1)

    def run_experts(lp, buf):
        if not cap_axes:
            return _experts(lp, buf)
        hout = _experts(lp, buf[:, c0:c0 + cn])
        for a in reversed(cap_axes):  # the innermost split first
            hout = _Gather.apply(hout, 1, mesh.get_group(a))
        return hout

    def local(xl, router, wg, wu, wd, *shared):
        xf = xl.reshape(T, d)
        lp = {"router": router, "we_gate": wg, "we_up": wu, "we_down": wd}
        out, idx, probs = _dispatch(lp, cfg, xf, lo, wg.shape[0], C, run_experts)
        if shared:
            out = out + mlp_forward(dict(zip(("w_gate", "w_up", "w_down"), shared)), xf)
        out = out.reshape(B, S, d)[r0:r0 + n_rows]
        return out, _aux(idx, probs, cfg.num_experts)

    out_pl = tuple(Partial() if e else pl for e, pl in zip(ep, rows_pl))
    flat = {"router": p["router"], "we_gate": p["we_gate"], "we_up": p["we_up"],
            "we_down": p["we_down"], **{f"shared/{k}": v for k, v in p.get("shared", {}).items()}}
    return local_map(local, out_placements=(out_pl, rep), in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, *(flat[k] for k in keys))


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over a process group; the gradient is the
    output's gradient reduce-scattered back along ``dim``."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, dim: int, group) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        ctx.dim, ctx.group = dim, group
        return funcol.wait_tensor(funcol.all_gather_tensor(t, dim, group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        scattered = funcol.reduce_scatter_tensor(g, "sum", ctx.dim, ctx.group)
        return funcol.wait_tensor(scattered), None, None


class _PSum(torch.autograd.Function):
    """Sum over a process group, as ``jax.lax.psum`` inside the reference's
    ``shard_map``: each rank's gradient is the output's gradient (the
    consumers downstream are replicated over the group)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_forward_shard_map(
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    x: torch.Tensor,
    mesh,
    dp_axes: Tuple[str, ...] = ("data",),
    ep_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with explicit per-device dispatch (the reference's
    ``moe_forward_shard_map``).  Each (data, model) device routes its
    *local* tokens, keeps those routed to its own range of experts at the
    local capacity ``capacity(t_loc)``, runs its expert shard, and sums the
    partial outputs over ``ep_axis``: the same all-reduce a tensor-parallel
    MLP pays; the dispatch itself moves no bytes.  The shared experts are
    tensor parallel the same way; the aux loss is averaged over the data
    axes.  Ties go to the lower index.

    ``mesh`` is a ``DeviceMesh`` with a running process group.  ``x`` and
    ``p`` are DTensors on it (the dry run), or this rank's copies of the
    whole arrays: it then takes its own rows and experts, and returns the
    whole output, gathered over the data axes."""
    from torch.distributed import _functional_collectives as funcol

    B, S, d = x.shape
    E = cfg.num_experts
    names = list(mesh.mesh_dim_names)
    ep = mesh.size(names.index(ep_axis))
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} devices of {ep_axis!r}")
    e_loc = E // ep
    dp_size = math.prod(mesh.size(names.index(a)) for a in dp_axes)
    t_loc = (B // dp_size if B % dp_size == 0 else B) * S
    c_loc = capacity(t_loc, cfg)
    dp = dp_axes if B % dp_size == 0 and B >= dp_size else ()
    me = mesh.get_local_rank(ep_axis)
    ep_group = mesh.get_group(ep_axis)
    shared_keys = ("w_gate", "w_up", "w_down") if cfg.num_shared_experts else ()

    def body(x_loc, router, we_gate, we_up, we_down, *shared):
        Bl, Sl, _ = x_loc.shape
        xf = x_loc.reshape(Bl * Sl, d)
        lp = {"router": router, "we_gate": we_gate, "we_up": we_up, "we_down": we_down}
        out, idx, probs = _dispatch(lp, cfg, xf, me * e_loc, e_loc, c_loc)
        out = _PSum.apply(out, ep_group)  # partial expert outputs combine
        if shared:
            # shared experts are model-sharded like a dense TP MLP
            wg, wu, wd = shared
            hs = F.silu(xf @ wg) * (xf @ wu)
            out = out + _PSum.apply(hs @ wd, ep_group)
        aux = _aux(idx, probs, E)
        for a in dp:
            aux = funcol.wait_tensor(funcol.all_reduce(aux, "sum", mesh.get_group(a)))
        return out.reshape(Bl, Sl, d), aux / (dp_size if dp else 1)

    weights = [p["router"], p["we_gate"], p["we_up"], p["we_down"]]
    weights += [p["shared"][key] for key in shared_keys]
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        rep = tuple(Replicate() for _ in names)
        on_ep = lambda dim: tuple(Shard(dim) if a == ep_axis else Replicate() for a in names)
        x_pl = tuple(Shard(0) if a in dp else Replicate() for a in names)
        in_pl = (x_pl, rep, on_ep(0), on_ep(0), on_ep(0))
        in_pl += (on_ep(1), on_ep(1), on_ep(0)) if shared_keys else ()
        return local_map(body, out_placements=(x_pl, rep), in_placements=in_pl,
                         device_mesh=mesh, redistribute_inputs=True)(x, *weights)
    # this rank's copies of the whole arrays: its rows, experts and columns
    row = 0
    for a in dp:
        row = row * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    bl = B // dp_size if dp else B
    experts = [w[me * e_loc:(me + 1) * e_loc] for w in weights[1:4]]
    shared = []
    if shared_keys:
        wg, wu, wd = weights[4:]
        ff = wg.shape[1] // ep
        shared = [wg[:, me * ff:(me + 1) * ff], wu[:, me * ff:(me + 1) * ff],
                  wd[me * ff:(me + 1) * ff]]
    out, aux = body(x[row * bl:(row + 1) * bl], weights[0], *experts, *shared)
    for a in reversed(dp):
        out = funcol.wait_tensor(funcol.all_gather_tensor(out, 0, mesh.get_group(a)))
    return out, aux
