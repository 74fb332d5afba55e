"""The port's dry run (fake tensors, DTensors on a fake process group)
against the JAX package's compiled dry run: per-device FLOPs of the same
smoke steps on one device, the collectives of the 8-card node mesh, the
kernel wrappers' fake route, and the CLI."""

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
from repro_torch.launch.mesh import make_production_mesh, make_slice_mesh  # noqa: E402
from repro_torch.launch.specs import ShapeSpec  # noqa: E402
from repro_torch.roofline.analysis import StepCounter  # noqa: E402

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


# the JAX package's per-device FLOPs of each smoke step on a one-device mesh:
# build_step, lower, compile, ``hlo_cost`` of the compiled HLO; printed as
# JSON by a process of its own, since compiling is the slow part
REFERENCE = r"""
import json, sys
import jax
from repro.configs import get_smoke_config
from repro.launch import specs
from repro.roofline.analysis import hlo_cost

mesh = jax.make_mesh((1, 1), ("data", "model"))
out = {}
for arch, kind, seq, batch in json.loads(sys.argv[1]):
    name = f"{kind}_{seq}_{batch}"
    specs.SHAPES[name] = specs.ShapeSpec(name, kind, seq, batch)
    b = specs.build_step(get_smoke_config(arch), name, mesh)
    with mesh:
        compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                           out_shardings=b.out_shardings).lower(*b.args).compile()
    out[f"{arch}/{kind}"] = hlo_cost(compiled.as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """Every (family, kind)'s reference FLOPs, compiled by three processes
    at once while the tests count the port's side."""
    combos = [(arch, k, s.seq_len, s.global_batch) for arch in FAMILIES.values()
              for k, s in STEPS.items()]
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
