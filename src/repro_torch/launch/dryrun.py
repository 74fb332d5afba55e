"""Dry run: price every (architecture x input shape) step on an H100 mesh.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each step on 512 placeholder TPU devices.  Here each
step runs once on fake tensors (no storage, no launch) as DTensors on a
fake process group's mesh, under :class:`StepCounter`, which counts
rank 0's FLOPs, bytes, collective bytes and peak memory.  For each combo:

  1. builds the mesh: one HGX H100 node, ``(data, model) = (2, 4)`` over 8
     cards on one NVSwitch (``--mesh 1x1`` is one card),
  2. builds the step (train/prefill/decode) with fake DTensor arguments
     placed by the model's partition specs,
  3. runs it under the counter; with ``--device cuda`` (the default) the
     kernel wrappers launch nothing and book their kernels' work, so the
     step is priced as the card runs it; ``--device cpu`` prices the
     kernels' plain versions, as the reference's jnp path is priced (the
     fake tensors are CPU ones either way: no card is needed, none is
     touched),
  4. writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``: the
     reference's roofline keys, plus the target, the kernels' booked work,
     the collective bytes by mesh axis and the seconds the run took.

Every term divides by the H100 SXM5 data sheet's constants
(``repro_torch.roofline.hw``): the dry run measures nothing on a card.
Failures here (a missing sharding rule, a shape mismatch) are bugs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Tuple, Union

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import NODE_SHAPE, make_slice_mesh
from repro_torch.launch.specs import SHAPES, ShapeSpec, build_step
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (
    RooflineReport,
    StepCounter,
    model_step_flops,
    tree_bytes,
)

OUT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")


def target(mesh_shape: Tuple[int, int]) -> str:
    chips = mesh_shape[0] * mesh_shape[1]
    card = (f"H100 SXM5 80GB (data sheet: {hw.PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s bf16, "
            f"{hw.HBM_BW / 1e12:g} TB/s HBM, NVLink {hw.NVLINK_BW / 1e9:g} GB/s)")
    if chips == 1:
        return f"one {card}"
    return (f"{chips} x {card} on one NVSwitch, mesh (data, model) = "
            f"({mesh_shape[0]}, {mesh_shape[1]})")


def parse_shape(text: str) -> ShapeSpec:
    """A ``SHAPES`` name, or ``kind:seq_len:global_batch`` for any other
    step (e.g. ``decode:2048:8``: an 8-slot decode step over 2048 rows)."""
    if text in SHAPES:
        return SHAPES[text]
    kind, seq, batch = text.split(":")
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"shape kind {kind!r} is not train, prefill or decode")
    return ShapeSpec(text.replace(":", "_"), kind, int(seq), int(batch))


def count_step(cfg, shape: ShapeSpec, mesh, device: str = "cuda", **knobs):
    """Run ``build_step(cfg, shape, mesh, **knobs)`` once on fake
    arguments under a :class:`StepCounter`, the kernels booked for
    ``device`` "cuda" and their plain versions counted for "cpu"; returns
    (the counter, the bundle, the local bytes of the step's outputs)."""
    from torch.distributed.tensor.experimental import implicit_replication

    bundle = build_step(cfg, shape, mesh, **knobs)
    counter = StepCounter({mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names},
                          kernels=device == "cuda")
    # plain tensors (positions, masks) meet DTensors as replicated ones
    with counter, implicit_replication():
        args = bundle.make_args()
        counter.start(args)
        out = bundle.fn(*args)
        counter.stop()
        out_bytes = float(tree_bytes(out))
    return counter, bundle, out_bytes


def run_one(
    arch: str,
    shape: Union[str, ShapeSpec],
    mesh_shape: Tuple[int, int] = NODE_SHAPE,
    device: str = "cuda",
    seq_axis: Optional[str] = "model",
    remat: bool = True,
    zero1: bool = False,
    infer_shard_data: bool = False,
    batch_all_axes: bool = False,
    moe_shard_map: bool = False,
    layers: Optional[int] = None,
    out_dir: str = OUT_DIR,
    tag: str = "",
    verbose: bool = True,
) -> dict:
    """Price one step; returns (and writes) its roofline dict.  ``layers``
    cuts the config's depth, as the card's own runs cut it."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = make_slice_mesh(*mesh_shape)
    mesh_name = "x".join(str(n) for n in mesh_shape)
    cfg = get_config(arch) if layers is None else get_config(arch, num_layers=layers)
    t0 = time.monotonic()
    counter, bundle, out_bytes = count_step(
        cfg, shape, mesh, device, seq_axis=seq_axis, remat=remat, zero1=zero1,
        infer_shard_data=infer_shard_data, batch_all_axes=batch_all_axes,
        moe_shard_map=moe_shard_map,
    )
    t1 = time.monotonic()

    report = RooflineReport(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name + (f"+{tag}" if tag else ""),
        chips=mesh_shape[0] * mesh_shape[1],
        flops_per_device=counter.flops,
        bytes_per_device=counter.bytes,
        collective_bytes_per_device=dict(counter.collectives),
        model_flops=model_step_flops(bundle.cfg, shape),
        peak_memory_per_device=float(counter.peak_bytes),
        output_bytes_per_device=out_bytes,
    )
    d = report.to_dict()
    d["target"] = target(mesh_shape)
    d["device"] = device
    d["layers"] = bundle.cfg.num_layers
    d["trace_seconds"] = t1 - t0
    d["collective_bytes_by_axis"] = dict(counter.collectives_by_axis)
    d["kernels"] = counter.kernels
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape.name}__{mesh_name}{('__' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(d, f, indent=2)
    if verbose:
        print(
            f"[dryrun] {arch:18s} {shape.name:12s} mesh={mesh_name:4s} device={device} "
            f"trace={t1 - t0:5.1f}s flops/dev={counter.flops:.4e} "
            f"bytes/dev={counter.bytes:.4e} coll/dev={sum(counter.collectives.values()):.4e} "
            f"compute={report.compute_s:.4e}s memory={report.memory_s:.4e}s "
            f"collective={report.collective_s:.4e}s dominant={report.dominant} "
            f"peak/dev={counter.peak_bytes / 1e9:.2f}GB",
            flush=True,
        )
    return d


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Price (arch x shape) steps on an H100 mesh from a fake run.",
        epilog="The reference's --donate-cache has no counterpart: the port updates "
               "its caches in place.  Its --act-tp, --kv-hint and --moe-shard-capacity "
               "(in-model sharding constraints) and --multi-pod are not ported.")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", type=parse_shape,
                    help=f"one of {', '.join(SHAPES)}, or kind:seq_len:global_batch")
    ap.add_argument("--all", action="store_true", help="every arch x every SHAPES entry")
    ap.add_argument("--mesh", default="x".join(map(str, NODE_SHAPE)),
                    help="data x model, e.g. 2x4 (one HGX node, the default) or 1x1")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: price the kernels as booked; cpu: price their plain versions")
    ap.add_argument("--layers", type=int, help="cut the config's depth to this many layers")
    ap.add_argument("--no-remat", action="store_true",
                    help="train without recomputing the blocks in the backward")
    ap.add_argument("--seq-axis", default="model")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--infer-shard-data", action="store_true")
    ap.add_argument("--batch-all-axes", action="store_true")
    ap.add_argument("--moe-shard-map", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")
    mesh_shape = tuple(int(n) for n in args.mesh.split("x"))
    if len(mesh_shape) != 2:
        ap.error(f"--mesh {args.mesh!r} is not rows x cols")

    combos = (
        [(a, SHAPES[s]) for a in ARCH_IDS for s in SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    t0 = time.monotonic()
    failures = []
    for arch, shape in combos:
        try:
            run_one(
                arch, shape, mesh_shape=mesh_shape, device=args.device,
                seq_axis=None if args.seq_axis == "none" else args.seq_axis,
                remat=not args.no_remat, zero1=args.zero1,
                infer_shard_data=args.infer_shard_data,
                batch_all_axes=args.batch_all_axes, moe_shard_map=args.moe_shard_map,
                layers=args.layers, out_dir=args.out_dir, tag=args.tag,
            )
        except Exception as e:  # noqa: BLE001 — report all failures at the end
            failures.append((arch, shape.name, repr(e)))
            traceback.print_exc()
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"dry-run OK: {len(combos)} combos in {time.monotonic() - t0:.1f}s")


if __name__ == "__main__":
    main()
