"""Public wrappers around the CUDA kernels, in model layout.

A tensor on the CPU goes to the kernel's plain PyTorch version (the tests
run there).  A tensor on a CUDA device goes to the kernel, which is built
at first use; if it cannot run, the wrapper raises.  No path falls back to
the plain version on a card.  Any other device raises.

Each wrapper counts its kernel launches in :data:`LAUNCHES`, by its own
name (CPU calls are not counted), so a run can show that its main path
went through the kernels: set the counts to 0 with :func:`reset_launches`,
run, read :func:`launches`.  Beside the counter, :func:`span` names a
stretch of the engine's or the model's host work for a torch profiler:
a range while a profiler runs, a shared no-op otherwise.

The dry run (:mod:`repro_torch.launch.dryrun`) takes a third route for
fake tensors (``FakeTensorMode``): a fake CUDA tensor, or a fake one owned
by a :class:`~repro_torch.roofline.analysis.StepCounter` that prices the
card's kernels, launches nothing and builds nothing.  The wrapper returns
outputs of the kernel's shapes and books the kernel's work, by its
module's ``work`` formula, to that counter; it is not counted as a
launch.  A DTensor input runs the wrapper on its
local shards (:func:`on_shards`): batch and heads may be sharded, any
other sharding is gathered first.

Training reaches two of the kernels, flash attention and the SSD scan.
When grad mode is on and an input requires grad, their wrappers on a card
go through :class:`FlashAttentionFn` and :class:`SsmScanFn` with the
kernels' halves: the forward kernel, which under grad also keeps what the
backward needs (flash's row log-sum-exp; the scan's scratch: C·Bᵀ, the
entering states, the decay exponents), and a backward kernel
(``csrc/flash_attention_bwd.cu``, ``csrc/ssm_scan_bwd.cu``), counted as
``flash_attention_bwd`` and ``ssm_scan_bwd``.  The JAX package has no
backward kernel: its training differentiates its jnp path, whose
gradients these compute.  On the dry run's fake route the Functions get
halves that book the forward's ``work`` and the backward's ``work_bwd``
and launch nothing.  Without grad the wrappers launch the forward kernel
directly.  On the CPU the plain versions are differentiable as they
stand, and the wrappers never build a Function; the CPU tests give the
Functions the plain halves (the plain forward and the explicit plain
backward: ``flash_attention_bwd_plain``, ``ssm_scan_bwd_plain``) and hold
them to autograd.  The two decode kernels have no gradient, and their
wrappers raise under grad rather than return an output that autograd
cannot differentiate.  Under activation checkpointing the forward runs
twice, and so counts two launches (the backward one).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import norm_rope as _nr
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssm_scan as _ssm


def _route(t: torch.Tensor, what: str) -> str:
    """"kernel", "plain" (the CPU), or "fake" (the dry run's card)."""
    from repro_torch.roofline.analysis import booking_counter

    if t.device.type == "cuda":
        return "fake" if isinstance(t, FakeTensor) else "kernel"
    if t.device.type == "cpu":
        return "fake" if booking_counter(t) is not None else "plain"
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def _book(t: torch.Tensor, what: str, work: Tuple[float, float]) -> None:
    """Book a fake call's (FLOPs, bytes) to the StepCounter owning ``t``."""
    from repro_torch.roofline.analysis import booking_counter

    counter = booking_counter(t)
    if counter is not None:
        counter.book(what, *work)


# (batch dim, heads dim) of a wrapper's tensor argument or output; None: none
Dims = Tuple[Optional[int], Optional[int]]


def on_shards(fn: Callable, args: Sequence[torch.Tensor], dims: Sequence[Dims],
               out_dims: Sequence[Dims]):
    """``fn`` on the local shards of DTensor ``args`` (``args[0]`` leads).
    On each mesh axis where the lead is sharded over its batch (or heads)
    and every argument's batch (heads) divides evenly, each argument is
    sharded over its own; an argument with a single head keeps it whole
    (GQA's one KV head serves every query head).  On every other axis all
    arguments are gathered whole.  The redistributions are DTensor's own
    collectives, so the dry run counts them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = args[0]
    mesh = lead.device_mesh
    args = [a if isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]
    in_pl = [[] for _ in args]
    out_pl = [[] for _ in out_dims]
    for axis, p in enumerate(lead.placements):
        n = mesh.size(axis)
        kind = next((j for j in (0, 1) if isinstance(p, Shard) and p.dim == dims[0][j]), None)
        if kind is not None and not all(
                d[kind] is None or a.shape[d[kind]] % n == 0 or (kind == 1 and a.shape[d[1]] == 1)
                for a, d in zip(args, dims)):
            kind = None
        for pl, a, d in zip(in_pl, args, dims):
            dim = None if kind is None else d[kind]
            if dim is not None and kind == 1 and a.shape[dim] == 1:
                dim = None
            pl.append(Replicate() if dim is None else Shard(dim))
        for pl, d in zip(out_pl, out_dims):
            dim = None if kind is None else d[kind]
            pl.append(Replicate() if dim is None else Shard(dim))
    args = [_move_shards(a, pl) for a, pl in zip(args, in_pl)]
    return local_map(fn, out_placements=tuple(tuple(pl) for pl in out_pl),
                     in_placements=tuple(tuple(pl) for pl in in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _move_shards(a, placements):
    """``a`` with each mesh axis that shards one of its dimensions where
    ``placements`` shard another moved by one all-to-all: each device keeps
    its part of the new dimension from every device's part of the old one
    (a GPU mesh's move; DTensor moves a CPU mesh's shards by an all-gather).
    Uneven or doubly sharded dimensions are left to DTensor."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard

    for axis, (p, want) in enumerate(zip(a.placements, placements)):
        if not (isinstance(p, Shard) and isinstance(want, Shard) and p.dim != want.dim):
            continue
        src, dst, n = p.dim, want.dim, a.device_mesh.size(axis)
        others = [q for i, q in enumerate(a.placements) if i != axis]
        if (n == 1 or a.shape[src] % n or a.shape[dst] % n or Shard(src) in others
                or Shard(dst) in others or a.to_local().shape[dst] % n):
            continue
        t = a.to_local()
        x = t.unflatten(dst, (n, -1)).movedim(dst, 0).contiguous()
        y = funcol.all_to_all_single_autograd(
            x.flatten(0, 1), None, None, a.device_mesh.get_group(axis))
        y = funcol.wait_tensor(y).reshape(x.shape).movedim(0, src).flatten(src, src + 1)
        new = list(a.placements)
        new[axis] = Shard(dst)
        a = DTensor.from_local(y, a.device_mesh, new, run_check=False, shape=a.shape,
                               stride=torch.empty(a.shape, device="meta").stride())
    return a


def _is_dtensor(t: torch.Tensor) -> bool:
    return hasattr(t, "device_mesh")


def _wants_grad(*inputs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def _refuse_grad(what: str, *inputs: torch.Tensor) -> None:
    """Raise where autograd would need a gradient that the kernel lacks."""
    if _wants_grad(*inputs):
        raise RuntimeError(f"{what} has no gradient: call it under torch.no_grad()")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention in model layout, q (B, S, H, D), k/v (B, S, KV, D),
    with an explicit backward.  ``halves`` is a route's (forward, backward)
    on (B, H, S, D) views: ``forward(q, k, v, scale, window) -> (out,
    lse)`` and ``backward(q, k, v, out, lse, dout, scale, window) -> (dq,
    dk, dv)``; the wrapper passes :data:`FLASH_KERNELS` on a card and
    :data:`FLASH_FAKE` in the dry run.  Saves q, k, v, the output and the
    log-sum-exp."""

    @staticmethod
    def forward(ctx, halves, q, k, v, window: Optional[int], scale: float):
        ctx.backward_half, ctx.window, ctx.scale = halves[1], window, scale
        ctx.set_materialize_grads(False)
        out, lse = halves[0](*(x.transpose(1, 2) for x in (q, k, v)), scale, window)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        if dout is None:
            return (None,) * 6
        q, k, v, out, lse = ctx.saved_tensors
        grads = ctx.backward_half(*(x.transpose(1, 2) for x in (q, k, v, out)), lse,
                                  dout.transpose(1, 2), ctx.scale, ctx.window)
        return (None,) + tuple(g.transpose(1, 2) for g in grads) + (None, None)


def _model_layout(B: int, S: int, H: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """A fresh (B, S, H, D) tensor of ``like``'s dtype and device, as a
    (B, H, S, D) view."""
    return torch.empty((B, S, H, D), dtype=like.dtype, device=like.device).transpose(1, 2)


def _flash_kernel(q, k, v, scale, window, with_lse=True):
    """The forward kernel on (B, H, S, D) views, its output in model layout
    underneath; (out, the row log-sum-exp or None)."""
    B, H, S, D = q.shape
    out = _model_layout(B, S, H, D, q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    _fa.launch(q, k, v, out, scale, window, lse)
    LAUNCHES["flash_attention"] += 1
    return out, lse


def _flash_kernel_bwd(q, k, v, out, lse, dout, scale, window):
    """The backward kernel on (B, H, S, D) views; (dq, dk, dv) in model
    layout underneath."""
    # the backward reads every row as 16-byte chunks (an upstream gradient
    # may also come expanded, with stride 0: made whole in model layout)
    dout = dout.transpose(1, 2).contiguous().transpose(1, 2)
    q, k, v, out, dout = (_build.aligned16(x) for x in (q, k, v, out, dout))
    grads = tuple(_model_layout(x.shape[0], x.shape[2], x.shape[1], x.shape[3], x)
                  for x in (q, k, v))
    _fa.launch_bwd(q, k, v, out, lse, dout, *grads, scale, window)
    LAUNCHES["flash_attention_bwd"] += 1
    return grads


def _flash_fake(q, k, v, scale, window):
    """The dry run's forward: books the kernel's work; an empty output."""
    B, H, S, D = q.shape
    _book(q, "flash_attention", _fa.work(B, S, H, k.shape[1], D, window, q.element_size()))
    return _model_layout(B, S, H, D, q), None


def _flash_fake_bwd(q, k, v, out, lse, dout, scale, window):
    """The dry run's backward: books the backward kernel's work."""
    B, H, S, D = q.shape
    _book(q, "flash_attention_bwd",
          _fa.work_bwd(B, S, H, k.shape[1], D, window, q.element_size()))
    return tuple(torch.empty_like(x) for x in (q, k, v))


FLASH_KERNELS = (_flash_kernel, _flash_kernel_bwd)
FLASH_FAKE = (_flash_fake, _flash_fake_bwd)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention; (B, S, H, D) out."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _is_dtensor(q):
        return on_shards(lambda q, k, v: flash_attention(q, k, v, window, scale),
                          (q, k, v), ((0, 2),) * 3, ((0, 2),))
    route = _route(q, "flash_attention")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # bhsd views, no copy
    if route == "plain":
        return _fa.flash_attention_plain(qt, kt, vt, scale, window).transpose(1, 2)
    if route == "fake":
        return FlashAttentionFn.apply(FLASH_FAKE, q, k, v, window, scale)
    if _wants_grad(q, k, v):
        return FlashAttentionFn.apply(FLASH_KERNELS, q, k, v, window, scale)
    return _flash_kernel(qt, kt, vt, scale, window, with_lse=False)[0].transpose(1, 2)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) — model layout
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, S) bool — per-request validity (prefix or ring)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode over the flat cache; (B, 1, H, D) out.  A row with
    no valid entry gives zeros."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _refuse_grad("decode_attention", q, k, v)
    if _is_dtensor(q):
        return on_shards(lambda q, k, v, valid: decode_attention(q, k, v, valid, scale),
                          (q, k, v, valid), ((0, 2), (0, 2), (0, 2), (0, None)), ((0, 2),))
    route = _route(q, "decode_attention")
    if route == "fake":  # every cache row priced valid: the mask holds no data
        B, S, KV, D = k.shape
        _book(q, "decode_attention", _dec.work(B, S, q.shape[2], KV, D, q.element_size()))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    q3 = q[:, 0]
    if route == "plain":
        return _dec.decode_attention_plain(q3, k, v, valid, scale)[:, None]
    out = torch.empty(q3.shape, dtype=q.dtype, device=q.device)
    _dec.launch(q3, k, v, valid, out, scale)
    LAUNCHES["decode_attention"] += 1
    return out[:, None]


def paged_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D) — model layout
    pool_k: torch.Tensor,  # (num_pages, page_size, KV, D)
    pool_v: torch.Tensor,
    page_tables: torch.Tensor,  # (B, max_pages) int32
    lengths: torch.Tensor,  # (B,) int32 — valid tokens per request
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode over the paged pool; (B, 1, H, D) out."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _refuse_grad("paged_decode_attention", q, pool_k, pool_v)
    if _is_dtensor(q):
        return on_shards(
            lambda *a: paged_decode_attention(*a, scale=scale),
            (q, pool_k, pool_v, page_tables, lengths),
            ((0, 2), (None, 2), (None, 2), (0, None), (0, None)), ((0, 2),))
    route = _route(q, "paged_decode_attention")
    if route == "fake":  # every page of the table priced full: lengths hold no data
        B, max_pages = page_tables.shape
        tokens = B * max_pages * pool_k.shape[1]
        _book(q, "paged_decode_attention", _paged.work(
            B, tokens, q.shape[2], pool_k.shape[2], q.shape[3], q.element_size(),
            page_tables.numel()))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    q3 = q[:, 0]
    if route == "plain":
        return _paged.paged_decode_attention_plain(
            q3, pool_k, pool_v, page_tables, lengths, scale
        )[:, None]
    out = torch.empty(q3.shape, dtype=q.dtype, device=q.device)
    _paged.launch(q3, pool_k, pool_v, page_tables, lengths, out, scale)
    LAUNCHES["paged_decode_attention"] += 1
    return out[:, None]


class SsmScanFn(torch.autograd.Function):
    """The SSD scan with an explicit backward; returns (y, final state).
    ``halves`` is a route's (forward, backward): ``forward(x, dt, A, B_,
    C_, chunk) -> (y, final, saved)`` and ``backward(x, dt, A, B_, C_,
    chunk, *saved, dy, dfinal) -> (dx, ddt, dA, dB_, dC_)``, ``dfinal``
    None where the loss does not reach the final state; the wrapper passes
    :data:`SCAN_KERNELS` on a card (``saved``: the forward's scratch, C·Bᵀ,
    the entering states, the decay exponents) and :data:`SCAN_FAKE` in the
    dry run.  Saves the inputs and ``saved``."""

    @staticmethod
    def forward(ctx, halves, x, dt, A, B_, C_, chunk: int):
        ctx.backward_half, ctx.chunk = halves[1], chunk
        ctx.set_materialize_grads(False)
        y, final, saved = halves[0](x, dt, A, B_, C_, chunk)
        ctx.save_for_backward(x, dt, A, B_, C_, *saved)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        if dy is None and dfinal is None:
            return (None,) * 7
        x, dt, A, B_, C_, *saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy
        grads = ctx.backward_half(x, dt, A, B_, C_, ctx.chunk, *saved, dy, dfinal)
        return (None,) + tuple(grads) + (None,)


def _scan_kernel(x, dt, A, B_, C_, chunk):
    """The forward kernel: (y, final, its scratch)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    scratch = _ssm.scratch(Bb, S, H, P, N, chunk, x.device)
    _ssm.launch(x, dt, A, B_, C_, chunk, y, final, *scratch)
    LAUNCHES["ssm_scan"] += 1
    return y, final, scratch


def _scan_kernel_bwd(x, dt, A, B_, C_, chunk, cb, states, decay, dy, dfinal):
    """The backward kernels on the forward's scratch: (dx, ddt, dA, dB_, dC_)."""
    grads = _ssm.launch_bwd(x, dt, A, B_, C_, chunk, cb, states, decay, dy, dfinal)
    LAUNCHES["ssm_scan_bwd"] += 1
    return grads


def _scan_fake(x, dt, A, B_, C_, chunk):
    """The dry run's forward: books the kernel's work; empty outputs."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    _book(x, "ssm_scan", _ssm.work(Bb, S, H, P, N, chunk))
    return (torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device),
            torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device), ())


def _scan_fake_bwd(x, dt, A, B_, C_, chunk, dy, dfinal):
    """The dry run's backward: books the backward kernels' work."""
    Bb, S, H, P = x.shape
    _book(x, "ssm_scan_bwd",
          _ssm.work_bwd(Bb, S, H, P, B_.shape[-1], chunk, dfinal is not None))
    return tuple(torch.empty_like(t) for t in (x, dt, A, B_, C_))


SCAN_KERNELS = (_scan_kernel, _scan_kernel_bwd)
SCAN_FAKE = (_scan_fake, _scan_fake_bwd)


def ssm_scan(
    x: torch.Tensor,  # (B, S, H, P) float32
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan; returns y (B, S, H, P) and the final state
    (B, H, P, N), both float32.  A sequence shorter than ``chunk`` is one
    chunk, as in the Pallas wrapper; otherwise ``S % chunk`` must be 0."""
    if _is_dtensor(x):
        return on_shards(lambda *a: ssm_scan(*a, chunk), (x, dt, A, B_, C_),
                          ((0, 2), (0, 2), (None, 0), (0, None), (0, None)),
                          ((0, 2), (0, 1)))
    chunk = min(chunk, x.shape[1])
    route = _route(x, "ssm_scan")
    if route == "plain":
        return _ssm.ssm_scan_plain(x, dt, A, B_, C_, chunk)
    if route == "fake":
        return SsmScanFn.apply(SCAN_FAKE, x, dt, A, B_, C_, chunk)
    if _wants_grad(x, dt, A, B_, C_):
        return SsmScanFn.apply(SCAN_KERNELS, x, dt, A, B_, C_, chunk)
    return _scan_kernel(x, dt, A, B_, C_, chunk)[:2]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, for its route; any other tensor as it is."""
    return t.to_local() if _is_dtensor(t) else t


def rmsnorm(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,  # x's shape: the residual stream
):
    """RMSNorm over the last axis, rounded as
    :func:`repro_torch.models.common.rmsnorm` rounds it.  With ``residual``
    it norms ``residual + x`` (rounded to x's dtype) and returns (the normed
    rows, that sum), the sum being the new residual stream; without, the
    normed rows.  On the CPU the plain ops run, on DTensors too, as they
    always ran; on a card one launch makes fresh outputs."""
    _refuse_grad("rmsnorm", x, w, *(() if residual is None else (residual,)))
    route = _route(_local(x), "rmsnorm")
    if route == "plain":
        return _nr.rmsnorm_plain(x, w, eps, residual)
    if _is_dtensor(x):
        rows = (0, 2 if x.dim() == 4 else None)  # batch, and heads of a per-head norm
        args, dims, outs = (x, w), (rows, (None, None)), (rows,)
        if residual is not None:
            args, dims, outs = args + (residual,), dims + (rows,), (rows, rows)
        return on_shards(lambda x, w, *r: rmsnorm(x, w, eps, *r), args, dims, outs)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = None if residual is None else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if route == "fake":
        D = x.shape[-1]
        _book(x, "rmsnorm", _nr.work_rmsnorm(x.numel() // D, D, x.element_size(),
                                             residual is not None))
    else:
        _nr.launch_rmsnorm(x, w, out, eps, residual, s)
        LAUNCHES["rmsnorm"] += 1
    return out if residual is None else (out, s)


def rope(
    q: torch.Tensor,  # (B, S, H, hd) — model layout
    k: torch.Tensor,  # (B, S, KV, hd)
    positions: torch.Tensor,  # (B, S) int64
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-half rotary embedding of q and k at ``positions``, as
    :func:`repro_torch.models.common.apply_rope` computes it; returns (q,
    k).  On a card one launch rotates q and k in place and returns them;
    on the CPU the plain ops make new tensors, on DTensors too."""
    _refuse_grad("rope", q, k)
    route = _route(_local(q), "rope")
    if route == "plain":
        return _nr.rope_plain(q, k, positions, theta)
    if _is_dtensor(q):
        return on_shards(lambda q, k, p: rope(q, k, p, theta), (q, k, positions),
                          ((0, 2), (0, 2), (0, None)), ((0, 2), (0, 2)))
    B, S, H, hd = q.shape
    if route == "fake":
        _book(q, "rope", _nr.work_rope(B * S, H, k.shape[2], hd, q.element_size()))
    else:
        _nr.launch_rope(q, k, positions, theta)
        LAUNCHES["rope"] += 1
    return q, k


# each kernel's launches on a card, by its wrapper's name (the backward
# kernels by their forward's, with "_bwd")
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("decode_attention", "flash_attention", "paged_decode_attention", "ssm_scan",
     "flash_attention_bwd", "ssm_scan_bwd", "rmsnorm", "rope"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


_NO_SPAN = contextlib.nullcontext()
# an op-scope profiler range, not a user annotation (``record_function``):
# the profiler gives each kernel to its innermost user annotation alone,
# so a user range here would leave a caller's range around the call (a
# benchmark's step range, say) with no kernel on its device side
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range named ``name`` while a torch profiler runs, else
    one shared no-op: off, it costs a read of the profiler's module flag.
    The range lands on the profiler's clock, beside the device operations
    the code inside it launches."""
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return _NO_SPAN
