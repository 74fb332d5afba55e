"""The port's dry run (fake tensors, DTensors on a fake process group)
against the JAX package's compiled dry run: per-device FLOPs of the same
smoke steps on one device, the collectives of the 8-card node mesh and of
two nodes (priced per link), the in-model sharding knobs, the kernel
wrappers' fake route, and the CLI."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm_mod  # noqa: E402
from repro_torch.launch.dryrun import count_step  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    POD_AXES, POD_SHAPE, make_production_mesh, make_slice_mesh,
)
from repro_torch.launch.specs import ShapeSpec, _dp_axes, build_step  # noqa: E402
from repro_torch.models.common import batch_spec  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.roofline.analysis import RooflineReport, StepCounter, link_bw  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# the smoke steps both packages price: small enough that the port's plain
# SSD scan (a Python loop over chunks) stays fast, the kinds the SHAPES have
STEPS = {
    "train": ShapeSpec("test_train", "train", 256, 4),
    "prefill": ShapeSpec("test_prefill", "prefill", 1024, 2),
    "decode": ShapeSpec("test_decode", "decode", 2048, 8),
}
FAMILIES = {"dense": "qwen3-8b", "vlm": "internvl2-1b", "audio": "musicgen-large",
            "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b", "moe": "deepseek-v3-671b"}
KNOBS = ("act_tp", "kv_hint", "moe_shard_capacity")
KNOB_ARCH = "deepseek-v2-236b"  # MLA attention and MoE: every knob acts on it


# the JAX package's per-device FLOPs of each smoke step: build_step, lower,
# compile, ``hlo_cost`` of the compiled HLO; printed as JSON by a process of
# its own, since compiling is the slow part.  A combo without a knob is the
# baseline on one device ("arch/kind"); one with a knob ("none" for none)
# runs on a mesh of host devices with Auto axes, which the reference's
# sharding constraints need ("arch/kind/knob/RxC")
REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch import specs
from repro.roofline.analysis import hlo_cost

out = {}
for arch, kind, seq, batch, knob, (rows, cols) in json.loads(sys.argv[1]):
    name = f"{kind}_{seq}_{batch}"
    specs.SHAPES[name] = specs.ShapeSpec(name, kind, seq, batch)
    devices = jax.devices()[:rows * cols]
    if knob is None:
        mesh = jax.make_mesh((rows, cols), ("data", "model"), devices=devices)
        key, kw = f"{arch}/{kind}", {}
    else:
        mesh = jax.make_mesh((rows, cols), ("data", "model"), devices=devices,
                             axis_types=(AxisType.Auto,) * 2)
        key, kw = f"{arch}/{kind}/{knob}/{rows}x{cols}", {} if knob == "none" else {knob: True}
    b = specs.build_step(get_smoke_config(arch), name, mesh, **kw)
    with mesh:
        compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings).lower(*b.args).compile()
    out[key] = hlo_cost(compiled.as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Every (family, kind)'s reference FLOPs, and the knob steps', compiled
    by three processes at once while the tests count the port's side."""
    combos = [(arch, k, s.seq_len, s.global_batch, None, (1, 1)) for arch in FAMILIES.values()
              for k, s in STEPS.items()]
    train, prefill = STEPS["train"], STEPS["prefill"]
    combos += [(KNOB_ARCH, "train", train.seq_len, train.global_batch, knob, (1, 1))
               for knob in ("none",) + KNOBS]
    combos += [(KNOB_ARCH, k, s.seq_len, s.global_batch, knob, (2, 4))
               for k, s in (("train", train), ("prefill", prefill))
               for knob in ("none", "moe_shard_capacity")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(combos[i::3])],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for i in range(3)]
    got = {}

    def flops(key):
        if not got:
            try:
                outs = [proc.communicate(timeout=600) for proc in procs]
            finally:
                for proc in procs:
                    proc.kill()
            for proc, (out, err) in zip(procs, outs):
                assert proc.returncode == 0, err[-3000:]
                got.update(json.loads(out.strip().splitlines()[-1]))
        return got[key]

    yield flops
    for proc in procs:
        proc.kill()


@pytest.mark.parametrize("kind", list(STEPS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_device_flops_match_the_reference_hlo(family, kind, reference):
    """Matmul FLOPs of the plain path (``--device cpu``) on a (1, 1) mesh
    equal the reference's dots within 1%.  Every family comes within it:
    the SSD scans differ (the port's plain scan against the reference's
    jnp chunking) by at most 0.05% and the MoE train steps by 0.08%."""
    arch = FAMILIES[family]
    counter, _, _ = count_step(get_smoke_config(arch), STEPS[kind], make_slice_mesh(1, 1),
                               "cpu")
    assert counter.flops == pytest.approx(reference(f"{arch}/{kind}"), rel=0.01)
    assert counter.collectives_by_axis == {}  # one device: nothing to exchange


def test_node_mesh_counts_the_gradient_and_tensor_parallel_all_reduces():
    """On the fake (2, 4) node: the smoke train step syncs gradients over
    "data" and the decode step all-reduces the tensor-parallel partial
    sums over "model".  Each device takes at most half the decode's FLOPs
    (the batch splits over "data"; the smoke's 2 KV heads do not split over
    4, so its attention is computed whole on each "model" device)."""
    cfg = get_smoke_config("qwen3-8b")
    node = make_production_mesh()
    train, _, _ = count_step(cfg, STEPS["train"], node)
    assert train.collectives_by_axis.get("all-reduce/data", 0) > 0
    decode, _, _ = count_step(cfg, STEPS["decode"], node)
    assert decode.collectives_by_axis.get("all-reduce/model", 0) > 0
    one, _, _ = count_step(cfg, STEPS["decode"], make_slice_mesh(1, 1))
    assert one.flops / 8 <= decode.flops <= one.flops / 2
    assert 0 < decode.peak_bytes < one.peak_bytes


def fake(counter, *shape, dtype=torch.bfloat16):
    with counter:
        return torch.empty(shape, dtype=dtype)


def test_fake_route_books_each_kernel_without_a_build_or_a_launch(monkeypatch):
    """Fake tensors of a counter that prices the card's kernels take the
    wrappers' third route: outputs of the kernel's shapes, each kernel's
    work booked to the counter by its module's formula, nothing built,
    nothing launched."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name}"))
    ops.reset_launches()
    c = StepCounter(kernels=True)
    B, S, H, KV, D = 2, 256, 8, 2, 64
    q, k, v = fake(c, B, S, H, D), fake(c, B, S, KV, D), fake(c, B, S, KV, D)
    valid = fake(c, B, S, dtype=torch.bool)
    pool = fake(c, 33, 16, KV, D)
    table, lengths = fake(c, B, 16, dtype=torch.int32), fake(c, B, dtype=torch.int32)
    x, dt = fake(c, B, S, H, 64, dtype=torch.float32), fake(c, B, S, H, dtype=torch.float32)
    A, Bm = fake(c, H, dtype=torch.float32), fake(c, B, S, 32, dtype=torch.float32)
    with c:
        c.start(())
        o = ops.flash_attention(q, k, v, window=64)
        od = ops.decode_attention(q.narrow(1, 0, 1), k, v, valid)
        op = ops.paged_decode_attention(q.narrow(1, 0, 1), pool, pool, table, lengths)
        y, final = ops.ssm_scan(x, dt, A, Bm, Bm, 32)
    assert (o.shape, od.shape, op.shape) == (q.shape, (B, 1, H, D), (B, 1, H, D))
    assert (y.shape, final.shape) == (x.shape, (B, H, 64, 32))
    assert ops.launches() == {name: 0 for name in ops.launches()}
    want = {
        "flash_attention": fa_mod.work(B, S, H, KV, D, 64, 2),
        "decode_attention": dec_mod.work(B, S, H, KV, D, 2),
        "paged_decode_attention": paged_mod.work(B, B * 16 * 16, H, KV, D, 2, B * 16),
        "ssm_scan": ssm_mod.work(B, S, H, 64, 32, 32),
    }
    assert {n: (k["calls"], k["flops"], k["bytes"]) for n, k in c.kernels.items()} == {
        n: (1, *w) for n, w in want.items()}
    assert c.flops == sum(w[0] for w in want.values())


def test_without_kernel_pricing_fake_tensors_take_the_plain_versions():
    c = StepCounter()
    q = fake(c, 1, 64, 4, 32)
    with c:
        c.start(())
        ops.flash_attention(q, q, q)
    assert c.kernels == {} and c.flops == 2 * (2 * 4 * 64 * 64 * 32)  # q·kᵀ and p·v


def test_fake_route_books_the_local_shard_of_a_dtensor():
    """A DTensor input runs the wrapper on rank 0's shard: batch over
    "data" and heads over "model" cut the booked work by 8."""
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = make_slice_mesh(2, 4)
    c = StepCounter(kernels=True)
    B, S, H, KV, D = 4, 128, 8, 4, 32
    with c:
        q, k, v = (distribute_tensor(torch.empty((B, S, n, D), dtype=torch.bfloat16),
                                     mesh, [Shard(0), Shard(2)], src_data_rank=None)
                   for n in (H, KV, KV))
        c.start(())
        o = ops.flash_attention(q, k, v)
    assert o.shape == q.shape and tuple(o.placements) == (Shard(0), Shard(2))
    assert c.kernels["flash_attention"]["flops"] == fa_mod.work(B, S, H, KV, D, None, 2)[0] / 8
    assert c.collectives_by_axis == {}  # already placed as the kernel wants


def test_cli_writes_the_roofline_json_at_full_size(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internvl2-1b",
         "--shape", "decode_32k", "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "dry-run OK: 1 combos" in res.stdout
    d = json.loads((tmp_path / "internvl2-1b__decode_32k__2x4.json").read_text())
    keys = {"arch", "shape", "mesh", "chips", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "model_flops", "peak_memory_per_device",
            "output_bytes_per_device", "compute_s", "memory_s", "collective_s", "dominant",
            "useful_flops_ratio", "target"}
    assert keys <= set(d)
    assert d["chips"] == 8 and d["mesh"] == "2x4" and "NVSwitch" in d["target"]
    assert d["flops_per_device"] > 0 and math.isfinite(d["memory_s"])
    assert d["dominant"] in ("compute", "memory", "collective")


MOVE = r"""
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.kernels.ops import _move_shards

torch.set_num_threads(1)
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    full = torch.randn((4, 8, 6, 2), generator=torch.Generator().manual_seed(0))
    for src, dst in ((1, 2), (2, 1), (2, 3)):
        a = distribute_tensor(full, mesh, [Shard(0), Shard(src)])
        got = _move_shards(a, [Shard(0), Shard(dst)])
        assert tuple(got.placements) == (Shard(0), Shard(dst))
        assert torch.equal(got.to_local(), a.redistribute(mesh, [Shard(0), Shard(dst)]).to_local())
        assert torch.equal(got.full_tensor(), full)
finally:
    dist.destroy_process_group()
"""


def test_move_shards_matches_dtensor_on_four_gloo_ranks(tmp_path):
    """The all-to-all that moves a shard from one dimension to another
    (what the dry run counts in place of a CPU mesh's all-gather) gives the
    shards DTensor's own redistribution gives, on real data."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", MOVE, str(r), str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for r in range(4)]
    try:
        outs = [proc.communicate(timeout=120) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for r, (proc, (_, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {r}: {err[-2000:]}"


# -- the multi-node mesh (two HGX nodes) and the per-link collective term --------------


def report_of(counter):
    return RooflineReport(
        arch="a", shape="s", mesh="m", chips=1, flops_per_device=counter.flops,
        bytes_per_device=counter.bytes, collective_bytes_per_device=dict(counter.collectives),
        model_flops=1.0, collective_bytes_by_axis=dict(counter.collectives_by_axis))


def test_multi_pod_mesh_is_two_nodes_and_its_data_axes_match_the_reference():
    from jax.sharding import AbstractMesh

    from repro.launch import specs as jspecs
    from repro.models.common import batch_spec as jax_batch_spec

    mesh = make_production_mesh(multi_pod=True)
    assert mesh.mesh_dim_names == ("pod", "data", "model") == POD_AXES
    assert tuple(mesh.shape) == POD_SHAPE == (2, 2, 4) and mesh.size() == 16
    ref = AbstractMesh(POD_SHAPE, ("pod", "data", "model"))  # the reference's axis names
    for batch in (1, 2, 4, 6, 8, 32, 256):
        assert _dp_axes(mesh, batch) == jspecs._dp_axes(ref, batch)
    assert batch_spec(mesh.mesh_dim_names) == jax_batch_spec(ref.axis_names) == ("pod", "data")
    assert make_production_mesh().mesh_dim_names == ("data", "model")


def test_multi_pod_train_step_prices_the_pod_all_reduce_at_infiniband():
    """The smoke train step on two nodes syncs gradients over "pod" too;
    those bytes cross InfiniBand and are priced at IB_BW (C14), the rest
    at NVLink's rate."""
    cfg = get_smoke_config("qwen3-8b", num_layers=1)  # a 3-axis mesh propagates slowly
    c, _, _ = count_step(cfg, STEPS["train"], make_production_mesh(multi_pod=True),
                         remat=False)
    by_axis = c.collectives_by_axis
    pod = sum(n for k, n in by_axis.items() if k.endswith("/pod"))
    assert by_axis.get("all-reduce/pod", 0) > 0 and by_axis.get("all-reduce/data", 0) > 0
    assert link_bw("pod") == hw.IB_BW < hw.NVLINK_BW == link_bw("data") == link_bw("model")
    assert link_bw("pod_data") == hw.IB_BW
    rest = sum(by_axis.values()) - pod
    assert report_of(c).collective_s == pytest.approx(rest / hw.NVLINK_BW + pod / hw.IB_BW,
                                                      rel=1e-12)
    assert report_of(c).collective_s > sum(c.collectives.values()) / hw.NVLINK_BW


def test_one_node_collective_term_is_unchanged():
    """On one node every collective stays on NVLink: the per-link term is
    exactly the bytes over NVLINK_BW, as before the pod axis existed."""
    c, _, _ = count_step(get_smoke_config("qwen3-8b"), STEPS["train"], make_production_mesh())
    assert c.collectives_by_axis and not any(k.endswith("/pod") for k in c.collectives_by_axis)
    old = sum(c.collectives.values()) / hw.NVLINK_BW
    assert report_of(c).collective_s == old


def test_cli_multi_pod_and_the_knobs(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--multi-pod", "--device", "cpu",
         "--arch", "internvl2-1b", "--shape", "decode_32k", "--act-tp", "--kv-hint",
         "--moe-shard-capacity", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "dry-run OK: 1 combos" in res.stdout
    d = json.loads((tmp_path / "internvl2-1b__decode_32k__2x2x4.json").read_text())
    assert d["chips"] == 16 and d["mesh"] == "2x2x4"
    assert "2 HGX nodes" in d["target"] and "InfiniBand" in d["target"]
    assert "NVLink" in d["target"] and d["collective_bytes_by_axis"]
    assert d["collective_s"] == RooflineReport(**{k: d[k] for k in (
        "arch", "shape", "mesh", "chips", "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "model_flops", "collective_bytes_by_axis")}).collective_s
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--multi-pod", "--mesh", "1x1",
         "--device", "cpu", "--arch", "internvl2-1b", "--shape", "decode_32k",
         "--out-dir", str(tmp_path)], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert refused.returncode == 2 and "without --mesh" in refused.stderr


# -- the in-model sharding knobs (act_tp, kv_hint, moe_shard_capacity) -----------------


def norm(spec):
    """A partition spec as a tuple of axis tuples (None and () alike)."""
    if spec is None:
        return None
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["node", "two-nodes"])
def test_knob_specs_equal_the_reference(multi_pod):
    """Each knob's partition spec, for each step kind, is the one the
    reference's ``build_step`` gives its model: ``act_tp`` P(dp, None,
    "model") outside decode, ``kv_hint`` P(dp, None, None, None),
    ``moe_shard_capacity`` P("model", "data", None)."""
    from jax.sharding import AbstractMesh

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.launch import specs as jspecs
    from repro.models.common import batch_spec as jax_batch_spec

    mesh = make_production_mesh(multi_pod=multi_pod)
    ref_mesh = AbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names)
    arch = "deepseek-v2-236b"
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for on in (False, True):
            knobs = {k: on for k in KNOBS}
            ref = jspecs.build_step(jax_smoke_config(arch), shape, ref_mesh, **knobs).model
            got = build_step(get_smoke_config(arch), shape, mesh, **knobs).model
            want_act = (jax_batch_spec(ref.mesh_axes), None, "model") if ref.act_tp else None
            assert norm(got.act_tp) == norm(want_act), shape
            assert norm(got.kv_hint) == norm(ref.kv_hint), shape
            assert norm(got.moe_buf_spec) == norm(ref.moe_buf_spec), shape
            assert (got.act_tp is not None) == (on and shape != "decode_32k")


@pytest.mark.parametrize("knob", KNOBS)
def test_knob_leaves_one_device_flops_unchanged(knob, reference):
    """On one device each knob leaves the train step's FLOPs as they were,
    in both packages, and the port's equal the reference's compiled step
    with the knob on within 1% (the MoE train step's 0.5%)."""
    cfg = get_smoke_config(KNOB_ARCH)
    one = make_slice_mesh(1, 1)
    base, _, _ = count_step(cfg, STEPS["train"], one, "cpu")
    c, _, _ = count_step(cfg, STEPS["train"], one, "cpu", **{knob: True})
    assert c.flops == base.flops and c.collectives_by_axis == {}
    ref = reference(f"{KNOB_ARCH}/train/{knob}/1x1")
    assert ref == reference(f"{KNOB_ARCH}/train/none/1x1")
    assert c.flops == pytest.approx(ref, rel=0.01)


def test_act_tp_turns_model_all_reduces_into_reduce_scatter_all_gather_pairs():
    """On the (2, 4) node the smoke train step's residual stream, sharded
    over its features, is reduce-scattered after each sublayer in place of
    the all-reduce, and all-gathered before the next."""
    cfg = get_smoke_config("qwen3-8b")
    node = make_production_mesh()
    base, _, _ = count_step(cfg, STEPS["train"], node, "cpu")
    tp, bundle, _ = count_step(cfg, STEPS["train"], node, "cpu", act_tp=True)
    assert bundle.model.act_tp == (("data",), None, "model")
    b, t = base.collectives_by_axis, tp.collectives_by_axis
    assert t["all-reduce/model"] < b["all-reduce/model"]
    assert t["reduce-scatter/model"] > b["reduce-scatter/model"]
    assert t["all-gather/model"] > b["all-gather/model"]
    decode, _, _ = count_step(cfg, STEPS["decode"], node, "cpu", act_tp=True)
    plain, _, _ = count_step(cfg, STEPS["decode"], node, "cpu")
    assert decode.collectives_by_axis == plain.collectives_by_axis  # decode never takes it


def test_kv_hint_gathers_k_and_v_over_the_model_axis_once():
    """deepseek-v2's smoke prefill on the node: its expanded K/V (4 heads,
    split over "model") are made batch-only, one all-gather of each per
    layer, and the FLOPs stay."""
    cfg = get_smoke_config("deepseek-v2-236b")
    node = make_production_mesh()
    base, _, _ = count_step(cfg, STEPS["prefill"], node, "cpu")
    hint, _, _ = count_step(cfg, STEPS["prefill"], node, "cpu", kv_hint=True)
    B, S = STEPS["prefill"].global_batch // 2, STEPS["prefill"].seq_len  # rows a data shard
    kv = cfg.num_layers * B * S * cfg.num_heads * (
        cfg.nope_head_dim + cfg.rope_head_dim + cfg.v_head_dim) * 2  # bf16
    added = hint.collectives_by_axis.get("all-gather/model", 0) - base.collectives_by_axis.get(
        "all-gather/model", 0)
    assert added == kv and hint.flops == base.flops


def test_moe_shard_capacity_splits_the_expert_buffer_over_model_and_data(reference):
    """With the buffer P("model", "data", None) on the node each device runs
    its quarter of the experts on half of their slots, and all-gathers the
    outputs over "data": the expert products' FLOPs halve, by as many FLOPs
    as the reference's compiled step on eight host devices sheds, in the
    prefill and in the train step."""
    from repro_torch.models.moe import capacity

    cfg = get_smoke_config(KNOB_ARCH)
    node = make_production_mesh()
    shape = STEPS["prefill"]
    base, _, _ = count_step(cfg, shape, node, "cpu")
    cap, bundle, _ = count_step(cfg, shape, node, "cpu", moe_shard_capacity=True)
    assert bundle.model.moe_buf_spec == ("model", "data", None)
    C = capacity(shape.global_batch * shape.seq_len, cfg)
    n_moe, e_loc = cfg.num_layers - cfg.first_dense_layers, cfg.num_experts // 4
    experts = n_moe * 3 * 2 * e_loc * C * cfg.d_model * cfg.moe_d_ff  # gate, up, down
    assert base.flops - cap.flops == experts / 2
    ref = {k: reference(f"{KNOB_ARCH}/{k}/none/2x4")
           - reference(f"{KNOB_ARCH}/{k}/moe_shard_capacity/2x4") for k in ("prefill", "train")}
    assert base.flops - cap.flops == ref["prefill"]
    gathered = n_moe * e_loc * C * cfg.d_model * 2  # each device's experts' outputs, bf16
    assert (cap.collectives_by_axis["all-gather/data"]
            - base.collectives_by_axis.get("all-gather/data", 0)) == gathered
    train_base, _, _ = count_step(cfg, STEPS["train"], node, "cpu")
    train, _, _ = count_step(cfg, STEPS["train"], node, "cpu", moe_shard_capacity=True)
    assert train_base.flops - train.flops == ref["train"]
    assert train.collectives_by_axis.get("reduce-scatter/data", 0) > 0  # its backward
