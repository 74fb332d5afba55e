"""Input shapes, arguments and shardings for every dry-run step.

The port's counterpart of the JAX package's ``launch/specs.py``.
``build_step(cfg, shape, mesh)`` returns the step function of an (arch x
shape x mesh) combination and a maker of its arguments: fake tensors (no
storage), each a DTensor on ``mesh`` placed by the model's partition
specs, made without a broadcast (``src_data_rank=None``).  The steps:

  train_4k     -> the train step  (params, opt_state, batch): loss,
                  backward and AdamW, ``training.train_loop``'s
  prefill_32k  -> prefill         (params, tokens|embeds)
  decode_32k   -> decode step     (params, cache, token, pos): 1 new token
  long_500k    -> decode step over a 524288-token context (the ring cache
                  of the sliding-window variant; the SSM state)

Knobs, as the reference's: ``seq_axis`` (the mesh axis the cache rows
shard over), ``zero1`` (AdamW moments also sharded over "data"),
``infer_shard_data`` (serving weights sharded over both axes),
``batch_all_axes`` (a decode batch over every axis) and ``moe_shard_map``
(expert-parallel MoE dispatch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import long_context_variant
from repro_torch.models import Model
from repro_torch.models.common import DTYPES, PartitionSpec, unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.training import adamw
from repro_torch.training.train_loop import make_train_step


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, long_context=True),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of any mesh with
    ``axis_names`` and a ``shape`` mapping (as a JAX mesh has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _dp_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Data-parallel axes actually usable for this batch size."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in sizes if a in ("pod", "data"))
    size = math.prod(sizes[a] for a in axes) if axes else 1
    return axes if axes and batch % size == 0 and batch >= size else ()


def placements(spec: PartitionSpec, mesh) -> list:
    """A partition spec as DTensor placements on ``mesh``: each mesh axis
    shards the tensor dimension whose entry names it, or replicates."""
    from torch.distributed.tensor import Replicate, Shard

    def names(entry):
        return entry if isinstance(entry, tuple) else (entry,)

    return [next((Shard(i) for i, e in enumerate(spec) if axis in names(e)), Replicate())
            for axis in mesh.mesh_dim_names]


def _distribute(mesh, tree, specs, make: Callable[[str, Any], torch.Tensor]):
    """DTensors for the leaves of ``tree`` (flat or nested), each made by
    ``make(key, leaf)`` and placed by its spec in ``specs``; no broadcast.
    On a one-device mesh nothing is sharded, so the leaves stay plain
    tensors (the same step, without DTensor's dispatch)."""
    from torch.distributed.tensor import distribute_tensor

    def leaf(k, v):
        t = make(k, v)
        if mesh.size() == 1:
            return t
        return distribute_tensor(t, mesh, placements(specs[k], mesh), src_data_rank=None)

    return {k: _distribute(mesh, v, specs[k], make) if isinstance(v, dict) else leaf(k, v)
            for k, v in tree.items()}


def shape_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    if shape.long_context and cfg.arch_type != "ssm":
        return long_context_variant(cfg)
    return cfg


@dataclasses.dataclass
class StepBundle:
    """Everything the dry run needs for one (arch x shape x mesh)."""

    fn: Callable
    make_args: Callable[[], Tuple[Any, ...]]  # call under a FakeTensorMode
    in_specs: Tuple[Any, ...]  # partition-spec trees of the arguments
    model: Model
    cfg: ModelConfig


def _tokens_or_embeds(cfg: ModelConfig, B: int, S: int, dp) -> Tuple[str, tuple, Any, tuple]:
    """(batch key, shape, dtype, spec) of a step's model input."""
    if cfg.modality == "text":
        return "tokens", (B, S), torch.int64, (dp, None)
    return "embeds", (B, S, cfg.d_model), torch.bfloat16, (dp, None, None)


def build_step(
    arch_cfg: ModelConfig,
    shape: Union[str, ShapeSpec],
    mesh,
    seq_axis: Optional[str] = "model",
    remat: bool = True,
    zero1: bool = False,
    infer_shard_data: bool = False,
    batch_all_axes: bool = False,
    moe_shard_map: bool = False,
) -> StepBundle:
    """The step of ``shape`` (a ``SHAPES`` name or a ShapeSpec) for
    ``arch_cfg`` on ``mesh`` (a ``DeviceMesh`` over "data" and "model").
    The knobs beyond the paper-faithful baseline:
      zero1            -- AdamW moments also sharded over the data axis
      infer_shard_data -- serving weights sharded over data AND model axes
      batch_all_axes   -- a decode batch over every mesh axis, no cache rows
                          sharded (dense and MoE families)
      moe_shard_map    -- MoE layers dispatch expert parallel over "model"
    """
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = shape_config(arch_cfg, shape)
    device = mesh.device_type
    sizes = mesh_axes(mesh)
    dp = _dp_axes(mesh, shape.global_batch)
    if (
        batch_all_axes
        and shape.kind == "decode"
        and cfg.arch_type in ("dense", "vlm", "audio", "moe")
        and shape.global_batch % math.prod(sizes.values()) == 0
    ):
        # decode batch over every mesh axis: attention becomes fully local
        # per device (no cache resharding); weights are all-gathered instead
        dp = tuple(sizes)
        seq_axis = None
    model = Model(
        cfg,
        remat=remat and shape.kind == "train",
        mesh_axes=tuple(sizes),
        moe_mesh=mesh if moe_shard_map else None,
    )
    specs = model.param_specs()
    shapes = {k: s[0] for k, s in specs.items()}
    pspecs = model.param_partition_specs()
    if infer_shard_data and shape.kind != "train":
        pspecs = _dual_axis_specs(pspecs, shapes, mesh)
    dtype = DTYPES[cfg.dtype]

    def params():
        return unflatten(_distribute(mesh, shapes, pspecs, lambda k, s: torch.empty(
            s, dtype=dtype, device=device)))

    def dense(shape_, dtype_):
        return lambda k, s: torch.empty(shape_, dtype=dtype_, device=device)

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_specs = _zero1_specs(pspecs, shapes, mesh) if zero1 else pspecs
        key, inp_shape, inp_dtype, inp_spec = _tokens_or_embeds(cfg, B, S, dp)
        bspecs = {"labels": (dp, None), key: inp_spec}

        def make_args():
            moments = [unflatten(_distribute(mesh, shapes, opt_specs, lambda k, s: torch.empty(
                s, dtype=torch.float32, device=device))) for _ in range(2)]
            batch = _distribute(mesh, {"labels": None, key: None}, bspecs, lambda k, _: (
                torch.empty((B, S), dtype=torch.int64, device=device) if k == "labels"
                else torch.empty(inp_shape, dtype=inp_dtype, device=device)))
            return params(), adamw.AdamWState(0, *moments), batch

        return StepBundle(
            fn=make_train_step(model, adamw.AdamWConfig()),
            make_args=make_args,
            in_specs=(pspecs, adamw.AdamWState(None, opt_specs, opt_specs), bspecs),
            model=model,
            cfg=cfg,
        )

    if shape.kind == "prefill":
        key, inp_shape, inp_dtype, inp_spec = _tokens_or_embeds(cfg, B, S, dp)

        def make_args():
            inp = _distribute(mesh, {key: None}, {key: inp_spec},
                              dense(inp_shape, inp_dtype))[key]
            return params(), inp

        return StepBundle(
            fn=lambda p, x: model.prefill(p, **{key: x}),
            make_args=make_args,
            in_specs=(pspecs, inp_spec),
            model=model,
            cfg=cfg,
        )

    # decode
    cache_specs = model.cache_specs(seq_axis=seq_axis, dp=dp)

    def make_args():
        cache = model.init_cache(B, S, device=device)
        cache = _distribute(mesh, cache, cache_specs, lambda k, leaf: leaf)
        tok = _distribute(mesh, {"t": None, "p": None}, {"t": (dp, None), "p": (dp,)},
                          lambda k, _: torch.empty((B, 1) if k == "t" else (B,),
                                                   dtype=torch.int64, device=device))
        return params(), cache, tok["t"], tok["p"]

    return StepBundle(
        fn=model.decode_step,
        make_args=make_args,
        in_specs=(pspecs, cache_specs, (dp, None), (dp,)),
        model=model,
        cfg=cfg,
    )


def input_specs(arch_cfg: ModelConfig, shape: Union[str, ShapeSpec], mesh, **kwargs):
    """The fake arguments of one step and their partition specs (a thin
    veneer over :func:`build_step`); call under a FakeTensorMode."""
    bundle = build_step(arch_cfg, shape, mesh, **kwargs)
    return bundle.make_args(), bundle.in_specs


def _dual_axis_specs(pspecs: Dict[str, PartitionSpec], shapes: Dict[str, tuple],
                     mesh) -> Dict[str, PartitionSpec]:
    """Inference weight sharding over BOTH axes: keep the "model" dim and
    additionally shard the largest unsharded, divisible dim over "data"."""
    data = mesh_axes(mesh).get("data", 1)

    def upgrade(spec, shape):
        parts = list(spec) + [None] * (len(shape) - len(spec))
        # choose the largest eligible dim for the data shard
        best, best_dim = None, 0
        for i, (p_, dim) in enumerate(zip(parts, shape)):
            if p_ is None and dim % data == 0 and dim >= data and dim > best_dim:
                best, best_dim = i, dim
        if best is not None and best_dim >= 1024:  # skip tiny tensors
            parts[best] = "data"
        return tuple(parts)

    return {k: upgrade(spec, shapes[k]) for k, spec in pspecs.items()}


def _zero1_specs(pspecs: Dict[str, PartitionSpec], shapes: Dict[str, tuple],
                 mesh) -> Dict[str, PartitionSpec]:
    """ZeRO-1: additionally shard optimizer moments over the data axis on the
    largest dimension that is unsharded and divisible (beyond-paper §Perf)."""
    data = mesh_axes(mesh).get("data", 1)

    def upgrade(spec, shape):
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (p_, dim) in enumerate(zip(parts, shape)):
            if p_ is None and dim % data == 0 and dim >= data:
                parts[i] = "data"
                return tuple(parts)
        return tuple(parts)

    return {k: upgrade(spec, shapes[k]) for k, spec in pspecs.items()}
