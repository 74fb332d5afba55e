"""The port's expert-parallel MoE (``moe_forward_shard_map``) on 8 gloo
processes, a (data, model) = (2, 4) mesh, against its capacity dispatch
``moe_forward`` and against the JAX package's ``moe_forward_shard_map``
on 8 forced host devices, on the same numpy-seeded weights (the settings
of the JAX package's own test: deepseek-v3 smoke, 8 experts, top-2,
capacity factor 8)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
RANKS = 8

# weights and input as numpy float32, in the layout both packages share
SETUP = r"""
import dataclasses, sys
import numpy as np

def setup(get_smoke_config):
    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b", dtype="float32"),
                              num_experts=8, experts_per_token=2, capacity_factor=8.0)
    rng = np.random.default_rng(0)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    ffs = ff * cfg.num_shared_experts
    normal = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)
    p = {"router": normal(d, E, std=0.02), "we_gate": normal(E, d, ff, std=d ** -0.5),
         "we_up": normal(E, d, ff, std=d ** -0.5), "we_down": normal(E, ff, d, std=ff ** -0.5),
         "shared": {"w_gate": normal(d, ffs, std=d ** -0.5), "w_up": normal(d, ffs, std=d ** -0.5),
                    "w_down": normal(ffs, d, std=ffs ** -0.5)}}
    x = normal(4, 16, d, std=1.0)
    return cfg, p, x
"""

RANK = SETUP + r"""
import json, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke_config
from repro_torch.models.moe import moe_forward, moe_forward_shard_map

torch.set_num_threads(1)
rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 8), rank=rank, world_size=8)
try:
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg, p, x = setup(get_smoke_config)
    tp = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in p.items()}
    out, aux = moe_forward_shard_map(tp, cfg, torch.from_numpy(x), mesh)
    ref, aux_ref = moe_forward(tp, cfg, torch.from_numpy(x))
    err = float((out - ref).abs().max())
    json.dump({"err": err, "aux": float(aux), "aux_ref": float(aux_ref), "out": out.tolist()},
              open(out_path, "w"))
finally:
    dist.destroy_process_group()
"""

JAX = SETUP + r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.models.moe import moe_forward_shard_map

cfg, p, x = setup(get_smoke_config)
mesh = jax.make_mesh((2, 4), ("data", "model"))
with mesh:
    out, aux = jax.jit(lambda p, x: moe_forward_shard_map(p, cfg, x, mesh))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
print(json.dumps({"aux": float(aux), "out": np.asarray(out).tolist()}))
"""


def test_expert_parallel_moe_on_eight_gloo_ranks_matches_both_references(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jax_run = subprocess.Popen([sys.executable, "-c", JAX], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    store = tmp_path / "store"
    ranks = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(store),
                               str(tmp_path / f"rank{r}.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for r in range(RANKS)]
    try:
        outs = [proc.communicate(timeout=240) for proc in ranks]
        jax_out, jax_err = jax_run.communicate(timeout=240)
    finally:
        for proc in ranks + [jax_run]:
            proc.kill()
    for r, (proc, (_, err)) in enumerate(zip(ranks, outs)):
        assert proc.returncode == 0, f"rank {r}: {err[-2000:]}"
    assert jax_run.returncode == 0, jax_err[-2000:]
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(RANKS)]
    want = json.loads(jax_out.strip().splitlines()[-1])
    for r, res in enumerate(results):
        assert res["err"] <= 2e-4, f"rank {r}"
        assert abs(res["aux"] - res["aux_ref"]) < 0.02  # local capacity: an estimator
        assert abs(res["aux"] - want["aux"]) < 1e-5
        # every rank returns the whole output, gathered over "data"
        np.testing.assert_allclose(res["out"], want["out"], atol=2e-4, rtol=2e-4)
