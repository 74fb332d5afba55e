#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: the four CUDA kernels compiled by nvcc from
   ``src/repro_torch/kernels/csrc``, one nvcc each, all started together;
   each library's count of tensor-core (HMMA) instructions from
   ``cuobjdump -sass``, which must not be 0 for any of the four;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the main paths' shapes (attention at qwen3-8b's, zamba2-1.2b's,
   granite-20b's, phi4-mini-3.8b's (G = 3) and internvl2-1b's (G = 7), at
   head_dim 16 (phi4-mini's smoke heads) in bf16 and float32, the ring
   prefill's batch-8 window, the flat decode on prefix and ring masks, the
   SSD scan at mamba2-370m's and zamba2-1.2b's),
   with its time, the plain version's, a library call's where one exists,
   and the bound (the scan's both on the tensor cores, which it is held
   to, and on the float32 CUDA cores); for the paged decode and the scan,
   each launch's device time (torch.profiler), and for the paged decode its
   time with one wave of splits; then, under grad, flash's dq/dk/dv and
   the scan's five input gradients through the wrappers' autograd Function
   (kernel forward, the plain version's gradient backward) against the
   plain version's own autograd, at the training cell's shapes (flash
   q (4,1024,32,128) over 8 KV heads in bf16, a float32 smoke shape and a
   windowed one; the scan at mamba2-370m's (4,1024,32,64,128)), forward +
   backward timed beside the plain version's and, for flash, SDPA's;
4. parity: the engine on the card (kernels) and on the CPU (plain
   versions) give identical tokens on the float32 smoke configs of
   qwen3-8b, zamba2-1.2b, granite-20b, phi4-mini-3.8b and llama3-405b
   (head_dim 16), internvl2-1b and musicgen-large (paged and flat),
   mamba2-370m (flat), deepseek-v2-236b and deepseek-v3-671b (MoE with
   MLA, flat only; MLA is plain torch and launches no kernel) and the
   deepseek-v2 smoke config with GQA in place of MLA (paged and flat, the
   MoE family through flash and the decode kernels); and the ring caches
   (window 8) of qwen3-8b and of deepseek-v2 (MLA) driven through
   Model.prefill and Model.decode_step past the wrap; then training: three
   train steps on the card against the same on the CPU from one init
   (qwen3-8b, granite-20b, mamba2-370m, zamba2-1.2b, deepseek-v3-671b,
   internvl2-1b through embeddings, qwen3-8b under a window of 8 over 32
   tokens; some with remat), per-step loss, ce, aux, mtp and grad_norm,
   the launches each step implies and a grad_fn on every kernel output;
5. main paths: qwen3-8b (36 layers), mamba2-370m (48 layers), zamba2-1.2b
   (38 Mamba2 layers, 19 shared-attention calls), granite-20b (52 layers,
   on the paged and on the flat backend), phi4-mini-3.8b (32 layers),
   internvl2-1b (24 layers, fed token ids as the reference engine feeds
   it) and musicgen-large (48 layers) at full width and depth, then
   deepseek-v2-236b at full width with its depth cut to 6 layers (1 dense,
   5 MoE; the whole model, 472 GB, fits no card) on the flat latent
   cache, launching none of the four kernels, bf16,
   random weights from --seed, each serving 16 requests through Engine +
   run_closed_loop, with every kernel's launch count checked against the
   run's admissions and decode steps, and each printing the paper's §8.3
   feedback: the H100 roofline profile's predicted throughput for a
   7-slice (whole-card) instance, the measured one and the correction of
   a MeasuredProfile fed the run; then granite-20b's
   weights under a 512-token window: a batch-8 prefill of 1,024 tokens and
   16 decode steps past the wrap on ring caches; then, the serving models
   freed, training: qwen3-8b at full width with its depth cut to 8 of 36
   layers (2.79 B parameters; bf16 weights and gradients and float32 AdamW
   moments, 33.5 GB) and mamba2-370m whole, 10 steps each of 4 x 1,024
   tokens of the synthetic stream, no remat: step time, tokens/s, peak
   memory, the loss (it must fall) and the model-FLOPs share;
6. profiles: for qwen3-8b, granite-20b (flat) and deepseek-v2-236b,
   eight full decode steps timed on the host clock and eight more traced
   with torch.profiler (device-busy time by kernel family, idle share,
   launches per step); for
   qwen3-8b and mamba2-370m, one admission of a 1024-token prompt, timed
   and then traced the same way; one qwen3-8b training step split into
   forward, backward and optimizer, then traced;
7. dry run: three of the steps phase 6 timed (granite-20b's flat decode
   step of 8 slots, a qwen3-8b 1,024-token admission, the 8-layer qwen3-8b
   train step) priced by ``python -m repro_torch.launch.dryrun`` on the
   one-card mesh with the kernels booked, each run in a process of its own
   (its fake process group must not meet the real one below): compute and
   memory terms at the H100 data sheet's rates, their larger as the bound,
   and the bound's share of the measured device-busy time, which fails
   above 1.05; the train step's dry-run peak beside its measured one; then
   one HGX H100 node (8 cards as (data, model) = (2, 4)) at full size:
   qwen3-8b's four shapes, llama3-405b prefill_32k, deepseek-v3-671b
   decode_32k with the expert-parallel MoE, mamba2-370m long_500k, each
   step's three terms and its dominant one; then [ep]: deepseek-v2-236b's
   MoE layer at full width through ``moe_forward_shard_map`` on a one-rank
   NCCL group against ``moe_forward`` on the same inputs;
8. plan (host only, no kernel of its own): MIG-Serving on phase 5's
   measurements.  The seven architectures phase 5 serves on one card
   (qwen3-8b, mamba2-370m, zamba2-1.2b, granite-20b, phi4-mini-3.8b,
   internvl2-1b, musicgen-large) get one H100 MIG profile
   (``h100_arch_profiles`` in a ``MeasuredProfile`` fed each model's first
   phase-5 observation as the same measured/predicted ratio at every size
   where the model fits, so the whole card and the MIG sizes share one
   correction); a day workload at a 100 ms SLO asks each
   for 1-6 times its whole-card rate (drawn from --seed), a night one for
   0.2-0.45 of the day's.  ``TwoPhaseOptimizer`` on ``h100_mig_rules()``
   (the A100's placements within the card's 8 memory slices) at
   the reference's defaults places each; the whole card ("H100 as-is"), the
   4-2-1 static mix, greedy, two-phase and the lower bound are printed with
   the host seconds and the GA history, and the phase fails unless the plan
   is valid, every partition legal, lower bound <= two-phase <= greedy and
   two-phase <= as-is.  Beside it, ungated, the same counts for a profile
   corrected at size 7 only and for the uncorrected roofline (each at the
   same multiples of its own size-7 rates).  The controller then deploys
   the day plan on a simulated cluster and moves it to the night plan:
   action counts, ``parallel_makespan``, and a failure unless the final
   content is the night plan and every service kept min(day, night)
   throughout.  Then one 8-card node (``h100_node_rules()``, groups of 1,
   2, 4 or 8 cards): deepseek-v2-236b's whole model needs all 8 (min_size
   56) and gets a deployment of whole nodes; llama3-405b and
   deepseek-v3-671b fit no node.
   The phase fails above 60 s of host time;
9. control (host only): phase 8's day plan through the paper's §6-7
   serving system.  [route]: a ``WeightedRouter`` per service over its
   instances, weighted by the corrected profile's throughput at each
   instance's size and batch, 20,000 picks, each instance's share within
   n / 20000 + 1e-3 of its weight share (the reference's bound);
   [control]: for the ``none``, ``gpu_loss`` and ``instance_crash`` fault
   profiles, ``build_control_plane`` reconciles the plan onto a fresh
   ``SimulatedCluster``, fires the injector's device faults and reconciles
   again, with ``Observability.on()`` recording spans and metrics in sim
   time (stats, actions, makespan, the metrics snapshot and the span count
   printed); it fails unless every final diff is converged, every
   partition is legal under ``h100_mig_rules()`` and the spans are well
   formed; [token]: the token-level serving model of qwen3-8b's whole card
   on the profile phase 5's measurement corrects (``ewma=1.0``), at phase
   5's geometry (batch 8, pages of 16, max_len 2048, 16 requests of the
   mean prompt length and 64 new tokens), its requests/s beside the
   engine's (recorded, not gated).  The phase fails above 30 s of host time;
10. sim (host only): the paper's closed loop (Figures 13-14),
   ``ClusterSimulator`` on ``h100_mig_rules()`` and phase 8's measured
   profile, over a replayed trace of phase 8's day rates for an hour, then
   its night rates for an hour, in 60 s bins, with
   ``SimConfig(reoptimize_every_s=1800, latency_slo_ms=100)`` and the
   reference's defaults otherwise: once under the ``none`` fault profile
   and once under ``gpu_loss``, each on the fluid serving model.  Each
   [sim] line gives the per-service SLO satisfaction and mean attainment,
   the cards at the end and at the peak, the transitions and their
   makespans, the whole cards the peak demand would take as-is
   (``baseline_homogeneous``) and the host seconds; the ``gpu_loss`` one
   also the availability and the recovery time.  Each configuration runs
   twice, and the phase fails unless both runs give the same
   ``SimReport.to_json()`` bytes, every final partition is legal under
   ``h100_mig_rules()`` and every attainment is finite (attainment and card
   counts are recorded, not gated).  It fails above 60 s of host time.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this script, it exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks by input type
# (float32 is the CUDA-core rate: TF32 is off for PyTorch's matmuls here;
# tf32 is the tensor cores' rate, which the SSD scan's 3xTF32 products use)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# clock cycles the card spins before a timed run (about 0.1 s at the H100's clocks)
SPIN_CYCLES = 200_000_000

# phase 5's traffic: prompts of 128-1024 tokens drawn from --seed
REQUESTS = 16
NEW_TOKENS = 64

# the SSD scan's float32 bound: tests/test_kernels.py's tolerance for the Pallas scan
SCAN_TOL = 2e-3

# the MIG instance size the §8.3 feedback credits: all 7 compute slices
WHOLE_CARD = 7

# deepseek-v2-236b's depth on one card: its one dense layer and 5 MoE layers
# (21.25 B parameters, 42.49 GB in bf16; all 60 layers are 472 GB)
DSV2_LAYERS = 6

# qwen3-8b's depth when it trains on one card: 8 of its 36 layers, 2.79 B
# parameters, whose bf16 weights and gradients and float32 AdamW moments
# take 33.5 GB (all 36 layers: about 98 GB)
TRAIN_LAYERS = 8

# phase 5's training traffic: steps of batch x seq tokens of the synthetic
# stream at AdamW's default rate (the train CLI's 1e-3 makes the 8-layer
# model's loss rise over these 10 steps), one warmup step as the CLI sets
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 10, 4, 1024, 3e-4

DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention.py:74"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:83"
PAGED_REPLACES = "src/repro/kernels/paged_attention.py:89"
SSM_REPLACES = "src/repro/kernels/ssm_scan.py:80"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls.
    The card first spins for about 0.1 s, so the host has queued every
    launch before the first one runs: the events then time the device's
    work, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(torch, fn, calls: int = 10) -> str:
    """Device time of one call of ``fn`` by kernel (the launches of a
    wrapper), from torch.profiler over ``calls`` calls, as "name:ms,...".
    """
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"::(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key
            times[name] = times.get(name, 0.0) + e.self_device_time_total / calls / 1e3
    return ",".join(f"{k}:{v:.4f}" for k, v in sorted(times.items()))


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_generator(torch, rng):
    return torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))


def randn(torch, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def rotating(sets):
    """A function returning the next of ``sets`` in turn, so repeated timed
    calls do not all find one input set in the 50 MB L2 cache."""
    state = {"i": 0}

    def nxt():
        s = sets[state["i"] % len(sets)]
        state["i"] += 1
        return s

    return nxt


# -- phase 3: kernels against their plain versions ------------------------------


def check_paged(torch, ops, paged_mod, dtype, rng, cfg, batch, max_len, page_size):
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    max_pages = -(-max_len // page_size)
    num_pages = batch * max_pages + 1  # page 0 stays a dummy nobody owns
    lengths = rng.integers(1, max_len + 1, size=batch)
    lengths[0], lengths[-1] = 0, max_len  # an idle slot and a full one
    pt = torch.zeros((batch, max_pages), dtype=torch.int32)
    perm = rng.permutation(num_pages - 1) + 1
    nxt_page = 0
    for b in range(batch):
        n = -(-int(lengths[b]) // page_size)
        pt[b, :n] = torch.as_tensor(perm[nxt_page:nxt_page + n])
        nxt_page += n
    dev = "cuda"
    n_tok = int(lengths.sum())
    dbytes = torch.tensor([], dtype=dtype).element_size()
    set_bytes = 2 * num_pages * page_size * KV * D * dbytes
    gen = card_generator(torch, rng)
    sets = []
    for _ in range(min(4, max(1, math.ceil(150e6 / set_bytes)))):
        sets.append((
            randn(torch, (batch, 1, H, D), dtype, gen),
            randn(torch, (num_pages, page_size, KV, D), dtype, gen),
            randn(torch, (num_pages, page_size, KV, D), dtype, gen),
            pt.to(dev), torch.as_tensor(lengths, dtype=torch.int32, device=dev),
        ))
    q, pk, pv, ptd, lens = sets[0]
    got = ops.paged_decode_attention(q, pk, pv, ptd, lens)
    want = paged_mod.paged_decode_attention_plain(q[:, 0], pk, pv, ptd, lens)[:, None]
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=TOL[name], rtol=TOL[name])
    zero_row = got[0].abs().max().item() == 0.0
    nx = rotating(sets)
    ms = cuda_ms(torch, lambda: ops.paged_decode_attention(*nx()), 50)
    waves, paged_mod.PAGED_WAVES = paged_mod.PAGED_WAVES, 1  # the splits of one wave
    try:
        one_wave_ms = cuda_ms(torch, lambda: ops.paged_decode_attention(*nx()), 50)
    finally:
        paged_mod.PAGED_WAVES = waves
    splits = paged_mod.paged_splits(batch, KV, max_pages, page_size,
                                    paged_mod.sm_count(q.device), dtype)[0]
    per_launch = launch_ms(torch, lambda: ops.paged_decode_attention(*nx()))
    plain_ms = cuda_ms(torch, lambda: paged_mod.paged_decode_attention_plain(
        *(lambda s: (s[0][:, 0],) + s[1:])(nx())), 5)
    flops, nbytes = paged_mod.work(batch, n_tok, H, KV, D, dbytes, pt.numel())
    b_ms, b_by = bound(nbytes, flops, name)
    phase("kernels", kernel="paged_decode_attention", config=cfg.name, dtype=name, B=batch,
          H=H, KV=KV,
          D=D, page_size=page_size, lengths=f"{int(lengths.min())}..{int(lengths.max())}",
          tokens=n_tok, splits=splits, max_abs_err=f"{err:.3e}", ok=ok,
          zero_len_row_zero=zero_row, ms=f"{ms:.4f}", one_wave_ms=f"{one_wave_ms:.4f}",
          per_launch_ms=per_launch,
          plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    if not ok:
        fail(f"paged_decode_attention {name}: max |err| {err:.3e} > {TOL[name]}")
    if not zero_row:
        fail("paged_decode_attention: a length-0 row is not zero")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def decode_masks(rng, batch, S, window):
    """(batch, S) validity masks as the flat decode sees them: prefixes of
    ragged lengths 128-1088 (phase 5's prompts plus their new tokens), or,
    with ``window``, a ring's live slots: ``window`` positions that start
    at a random slot and wrap around the end of the cache."""
    valid = np.zeros((batch, S), bool)
    for b in range(batch):
        if window is None:
            valid[b, :int(rng.integers(128, 1089))] = True
        else:
            valid[b, (int(rng.integers(0, S)) + np.arange(window)) % S] = True
    return valid


def check_decode(torch, ops, dec_mod, dtype, rng, cfg, batch, S, window=None):
    """The flat decode kernel against its plain version at a config's
    decode shape; SDPA with the same boolean mask (GQA heads shared by
    ``enable_gqa``) timed beside it as a yardstick."""
    import torch.nn.functional as F

    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    name = str(dtype).replace("torch.", "")
    dbytes = torch.tensor([], dtype=dtype).element_size()
    gen = card_generator(torch, rng)
    set_bytes = 2 * batch * S * KV * D * dbytes
    sets = []
    for _ in range(min(8, max(1, math.ceil(150e6 / set_bytes)))):
        sets.append((
            randn(torch, (batch, 1, H, D), dtype, gen),
            randn(torch, (batch, S, KV, D), dtype, gen),
            randn(torch, (batch, S, KV, D), dtype, gen),
            torch.as_tensor(decode_masks(rng, batch, S, window), device="cuda"),
        ))
    q, k, v, valid = sets[0]
    got = ops.decode_attention(q, k, v, valid)
    want = dec_mod.decode_attention_plain(q[:, 0], k, v, valid)[:, None]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=TOL[name], rtol=TOL[name])
    nx = rotating(sets)
    ms = cuda_ms(torch, lambda: ops.decode_attention(*nx()), 50)
    plain_ms = cuda_ms(torch, lambda: dec_mod.decode_attention_plain(
        *(lambda s: (s[0][:, 0],) + s[1:])(nx())), 5)
    library_ms = cuda_ms(torch, lambda: (lambda s: F.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
        attn_mask=s[3][:, None, None, :], scale=1.0 / math.sqrt(D), enable_gqa=True))(nx()),
        20)
    rows = int(valid.sum().item())  # the K/V rows the mask marks valid
    flops, nbytes = dec_mod.work(batch, S, H, KV, D, dbytes, rows)
    b_ms, b_by = bound(nbytes, flops, name)
    phase("kernels", kernel="decode_attention", config=cfg.name, dtype=name, B=batch, S=S,
          H=H, KV=KV, D=D, mask="prefix" if window is None else f"ring{window}",
          valid_rows=rows, max_abs_err=f"{err:.3e}", ok=ok, ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    if not ok:
        fail(f"decode_attention {cfg.name} {name}: max |err| {err:.3e} > {TOL[name]}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def check_flash(torch, ops, fa_mod, dtype, rng, cfg, S, window, B=1):
    import torch.nn.functional as F

    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    name = str(dtype).replace("torch.", "")
    dbytes = torch.tensor([], dtype=dtype).element_size()
    set_bytes = B * S * (2 * H + 2 * KV) * D * dbytes
    gen = card_generator(torch, rng)
    sets = [tuple(randn(torch, (B, S, n, D), dtype, gen) for n in (H, KV, KV))
            for _ in range(min(8, max(1, math.ceil(150e6 / set_bytes))))]
    q, k, v = sets[0]
    scale = 1.0 / math.sqrt(D)
    got = ops.flash_attention(q, k, v, window=window)
    want = fa_mod.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale, window
    ).transpose(1, 2)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=TOL[name], rtol=TOL[name])
    nx = rotating(sets)
    iters = 20 if S >= 512 else 100
    ms = cuda_ms(torch, lambda: ops.flash_attention(*nx(), window=window), iters)
    plain_ms = cuda_ms(torch, lambda: fa_mod.flash_attention_plain(
        *(x.transpose(1, 2) for x in nx()), scale, window), 3)

    # yardstick only: one PyTorch call computing the same function on the
    # same inputs (never called by the port)
    qi = torch.arange(S, device="cuda")[:, None]
    kj = torch.arange(S, device="cuda")[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= kj > qi - window
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in nx()), attn_mask=None if window is None else mask,
        is_causal=window is None, scale=scale, enable_gqa=True), iters)
    flops, nbytes = fa_mod.work(B, S, H, KV, D, window, dbytes)
    b_ms, b_by = bound(nbytes, flops, name)
    phase("kernels", kernel="flash_attention", config=cfg.name, dtype=name, B=B, S=S, H=H,
          KV=KV, D=D,
          window=window, max_abs_err=f"{err:.3e}", ok=ok, ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    if not ok:
        fail(f"flash_attention {name} S={S} window={window}: max |err| {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def check_ssm(torch, ops, ssm_mod, rng, cfg, S):
    """The SSD scan against its plain version at a model's shapes, batch 1,
    inputs drawn as tests/test_kernels.py draws them."""
    import torch.nn.functional as F

    B, H, P, N, L = 1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    gen = card_generator(torch, rng)
    flops, nbytes = ssm_mod.work(B, S, H, P, N, L)
    sets = []
    for _ in range(min(8, max(1, math.ceil(150e6 / nbytes)))):
        sets.append((
            randn(torch, (B, S, H, P), torch.float32, gen),
            F.softplus(randn(torch, (B, S, H), torch.float32, gen)),
            -torch.exp(randn(torch, (H,), torch.float32, gen) * 0.5),
            randn(torch, (B, S, N), torch.float32, gen),
            randn(torch, (B, S, N), torch.float32, gen),
        ))
    y, fin = ops.ssm_scan(*sets[0], chunk=L)
    want_y, want_fin = ssm_mod.ssm_scan_plain(*sets[0], L)
    torch.cuda.synchronize()
    err = max((y - want_y).abs().max().item(), (fin - want_fin).abs().max().item())
    ok = (torch.allclose(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
          and torch.allclose(fin, want_fin, atol=SCAN_TOL, rtol=SCAN_TOL))
    nx = rotating(sets)
    ms = cuda_ms(torch, lambda: ops.ssm_scan(*nx(), chunk=L), 20)
    plain_ms = cuda_ms(torch, lambda: ssm_mod.ssm_scan_plain(*nx(), L), 3)
    per_launch = launch_ms(torch, lambda: ops.ssm_scan(*nx(), chunk=L))
    # held to the tensor cores, where its products run; the float32 CUDA
    # cores' bound beside it
    b_ms, b_by = bound(nbytes, flops, "tf32")
    cc_ms, cc_by = bound(nbytes, flops, "float32")
    phase("kernels", kernel="ssm_scan", config=cfg.name, dtype="float32", B=B, S=S, H=H, P=P,
          N=N, chunk=L, max_abs_err=f"{err:.3e}", ok=ok, ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=None, bound_ms=f"{b_ms:.4f}", bound_by=b_by,
          cuda_core_bound_ms=f"{cc_ms:.4f}", cuda_core_bound_by=cc_by, per_launch_ms=per_launch,
          gflop=f"{flops / 1e9:.3f}", mb=f"{nbytes / 1e6:.2f}")
    if not ok:
        fail(f"ssm_scan {cfg.name} S={S}: max |err| {err:.3e} > {SCAN_TOL}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# -- phase 3 (training): the gradients through the kernels ---------------------------


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in float32."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1.0))


def fwd_bwd(torch, fn, nx):
    """A call of ``fn``'s forward and backward on the next input set
    (inputs..., upstream gradient), as a train step runs them."""
    def run():
        *args, w = nx()
        out = fn(*args)
        torch.autograd.grad(out[0] if isinstance(out, tuple) else out, args, w)
    return run


def check_flash_grad(torch, ops, fa_mod, dtype, rng, B, S, H, KV, D, window):
    """dq, dk, dv through the wrapper's autograd Function (the kernel
    forward, the plain version's gradient backward) against the plain
    version's own autograd, on the same inputs; forward + backward timed
    beside the plain version's and SDPA's."""
    import torch.nn.functional as F

    name = str(dtype).replace("torch.", "")
    dbytes = torch.tensor([], dtype=dtype).element_size()
    gen = card_generator(torch, rng)
    set_bytes = B * S * (2 * H + 2 * KV) * D * dbytes
    sets = [tuple(randn(torch, (B, S, n, D), dtype, gen).requires_grad_() for n in (H, KV, KV))
            + (randn(torch, (B, S, H, D), dtype, gen),)
            for _ in range(min(4, max(1, math.ceil(150e6 / set_bytes))))]
    scale = 1.0 / math.sqrt(D)

    def plain(q, k, v):
        return fa_mod.flash_attention_plain(
            *(x.transpose(1, 2) for x in (q, k, v)), scale, window).transpose(1, 2)

    def kernel(q, k, v):
        return ops.flash_attention(q, k, v, window=window)

    q, k, v, w = sets[0]
    out = kernel(q, k, v)
    has_grad_fn = out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), w)
    want_out = plain(q, k, v)
    want = torch.autograd.grad(want_out, (q, k, v), w)
    torch.cuda.synchronize()
    errs = {"out": rel_err(out, want_out)}
    errs.update({f"d{n}": rel_err(g, r) for n, g, r in zip("qkv", got, want)})
    ok = has_grad_fn and max(errs.values()) <= TOL[name]
    del out, got, want_out, want
    nx = rotating(sets)
    qi = torch.arange(S, device="cuda")[:, None]
    kj = torch.arange(S, device="cuda")[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= kj > qi - window

    def sdpa(q, k, v):  # yardstick only, never called by the port
        return F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), attn_mask=None if window is None else mask,
            is_causal=window is None, scale=scale, enable_gqa=True).transpose(1, 2)

    iters = 10 if S >= 512 else 50
    ms = cuda_ms(torch, fwd_bwd(torch, kernel, nx), iters)
    plain_ms = cuda_ms(torch, fwd_bwd(torch, plain, nx), 3)
    library_ms = cuda_ms(torch, fwd_bwd(torch, sdpa, nx), iters)
    # forward 4 and backward 8 multiply-add flops per (query, key) pair and
    # head dim (Q·Kᵀ, P·V; dV, dP, dQ, dK): three times the forward's; q, k,
    # v and dO read, O, dQ, dK, dV written: twice the forward's bytes
    fwd_flops, fwd_bytes = fa_mod.work(B, S, H, KV, D, window, dbytes)
    flops, nbytes = 3 * fwd_flops, 2 * fwd_bytes
    b_ms, b_by = bound(nbytes, flops, name)
    phase("grad", kernel="flash_attention", dtype=name, B=B, S=S, H=H, KV=KV, D=D,
          window=window, grad_fn=has_grad_fn,
          **{f"err_{k}": f"{e:.3e}" for k, e in errs.items()}, tol=TOL[name], ok=ok,
          fwd_bwd_ms=f"{ms:.4f}", plain_fwd_bwd_ms=f"{plain_ms:.4f}",
          sdpa_fwd_bwd_ms=f"{library_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by)
    if not ok:
        fail(f"flash_attention gradient {name} S={S} window={window}: errors {errs}, "
             f"grad_fn={has_grad_fn}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms)


def check_scan_grad(torch, ops, ssm_mod, rng, B, S, H, P, N, L):
    """dx, ddt, dA, dB, dC through the wrapper's autograd Function against
    the plain version's own autograd (the final state unused, as in
    training); forward + backward timed beside the plain version's."""
    import torch.nn.functional as F

    gen = card_generator(torch, rng)
    flops, nbytes = ssm_mod.work(B, S, H, P, N, L)
    sets = []
    for _ in range(min(4, max(1, math.ceil(150e6 / nbytes)))):
        leaves = (randn(torch, (B, S, H, P), torch.float32, gen),
                  F.softplus(randn(torch, (B, S, H), torch.float32, gen)),
                  -torch.exp(randn(torch, (H,), torch.float32, gen) * 0.5),
                  randn(torch, (B, S, N), torch.float32, gen),
                  randn(torch, (B, S, N), torch.float32, gen))
        sets.append(tuple(t.requires_grad_() for t in leaves)
                    + (randn(torch, (B, S, H, P), torch.float32, gen),))

    def plain(*a):
        return ssm_mod.ssm_scan_plain(*a, L)

    def kernel(*a):
        return ops.ssm_scan(*a, chunk=L)

    *args, w = sets[0]
    y, final = kernel(*args)
    has_grad_fn = y.grad_fn is not None and final.grad_fn is not None
    got = torch.autograd.grad(y, args, w)
    want_y, _ = plain(*args)
    want = torch.autograd.grad(want_y, args, w)
    torch.cuda.synchronize()
    errs = {"y": rel_err(y, want_y)}
    errs.update({f"d{n}": rel_err(g, r)
                 for n, g, r in zip(("x", "dt", "A", "B", "C"), got, want)})
    ok = has_grad_fn and max(errs.values()) <= SCAN_TOL
    del y, final, got, want_y, want
    nx = rotating(sets)
    ms = cuda_ms(torch, fwd_bwd(torch, kernel, nx), 10)
    plain_ms = cuda_ms(torch, fwd_bwd(torch, plain, nx), 3)
    # the backward's products are twice the forward's; dy read, and y, the
    # final state and the five input gradients written, beside the inputs
    grad_bytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
    io_bytes = nbytes + 4 * B * S * H * P + grad_bytes
    b_ms, b_by = bound(io_bytes, 3 * flops, "tf32")
    cc_ms, cc_by = bound(io_bytes, 3 * flops, "float32")
    phase("grad", kernel="ssm_scan", dtype="float32", B=B, S=S, H=H, P=P, N=N, chunk=L,
          grad_fn=has_grad_fn, **{f"err_{k}": f"{e:.3e}" for k, e in errs.items()},
          tol=SCAN_TOL, ok=ok, fwd_bwd_ms=f"{ms:.4f}", plain_fwd_bwd_ms=f"{plain_ms:.4f}",
          library_ms=None, bound_ms=f"{b_ms:.4f}", bound_by=b_by,
          cuda_core_bound_ms=f"{cc_ms:.4f}", cuda_core_bound_by=cc_by)
    if not ok:
        fail(f"ssm_scan gradient S={S}: errors {errs}, grad_fn={has_grad_fn}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms)


# -- phase 4: the whole path on the card against the CPU --------------------------


def staggered_tokens(Engine, Request, model, params, prompts, new_tokens, backend):
    """Admit three requests at staggered steps, as the ragged oracle test
    does; returns every request's tokens."""
    eng = Engine(model, params, batch=3, max_len=64, kv_backend=backend)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    eng.admit(reqs[0])
    eng.step()
    eng.step()
    eng.admit(reqs[1])
    eng.step()
    eng.admit(reqs[2])
    while eng.num_live:
        eng.step()
    return [list(r.out_tokens) for r in reqs]


def ring_tokens(torch, model, params, prompts, steps, device):
    """Greedy tokens of Model.prefill over ``prompts`` (a multiple of the
    window) then ``steps`` Model.decode_step calls past the wrap, as the
    reference's long-context specs drive a ring cache."""
    B, S = prompts.shape
    with torch.no_grad():
        logits, cache = model.prefill(params, torch.as_tensor(prompts, device=device))
        tok = logits[:, 0].argmax(-1)
        out = [tok.tolist()]
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int64, device=device)
            logits, cache = model.decode_step(params, cache, tok[:, None], pos)
            tok = logits[:, 0].argmax(-1)
            out.append(tok.tolist())
    return out


def ring_parity(torch, ops, Model, tree_to, get_smoke_config, long_context_variant, rng,
                seed, arch="qwen3-8b"):
    """``arch``'s smoke config under long_context_variant(window=8): the
    card's tokens equal the CPU's through a 16-token prefill and 12 decode
    steps; GQA launches flash and the flat decode, MLA no kernel."""
    cfg = long_context_variant(get_smoke_config(arch, dtype="float32"), window=8)
    model = Model(cfg)
    params_cpu = model.init(seed, device="cpu")
    prompts = rng.integers(1, cfg.vocab_size, size=(2, 16))
    want = ring_tokens(torch, model, params_cpu, prompts, 12, "cpu")
    ops.reset_launches()
    got = ring_tokens(torch, model, tree_to(params_cpu, "cuda"), prompts, 12, "cuda")
    counts = ops.launches()
    gqa = cfg.attention_kind == "gqa"
    expect = {"decode_attention": 12 * cfg.num_layers * gqa,
              "flash_attention": cfg.num_layers * gqa,
              "paged_decode_attention": 0, "ssm_scan": 0}
    phase("parity", config=f"{cfg.name}-ring{cfg.sliding_window}", backend="ring",
          cpu_tokens=want, cuda_tokens=got, launches=json.dumps(counts))
    if got != want:
        fail(f"{cfg.name} ring: the card's tokens differ from the CPU's")
    if counts != expect:
        fail(f"{cfg.name} ring: launch counts {counts} != expected {expect}")


def attn_layers(cfg, remat: bool) -> int:
    """Flash launches of one training step: each GQA attention layer's
    forward, run twice when ``remat`` recomputes its stacked block (the
    MoE family's unrolled dense blocks are not recomputed); MLA none."""
    if cfg.arch_type == "ssm" or cfg.attention_kind != "gqa":
        return 0
    if cfg.arch_type == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every * (2 if remat else 1)
    n_dense = cfg.first_dense_layers if cfg.arch_type == "moe" else 0
    return n_dense + (cfg.num_layers - n_dense) * (2 if remat else 1)


def mamba_layers(cfg, remat: bool) -> int:
    """Scan launches of one training step: each Mamba2 layer's forward."""
    return cfg.num_layers * (2 if remat else 1) if cfg.arch_type in ("ssm", "hybrid") else 0


def grad_spy(torch, ops, kernels_bridge):
    """Route the model's calls of the two wrappers that training reaches
    through spies: every call under grad with an input that requires grad
    records whether its output has a grad_fn.  (The spies stand in the
    bridge's view of ``ops``, not in ``ops`` itself, whose wrappers count
    their launches on their own names.)  Returns (record, undo)."""
    record = {"checked": 0, "missing": []}

    def make(name):
        real = getattr(ops, name)

        def spy(*args, **kw):
            out = real(*args, **kw)
            if torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad
                                               for a in args):
                record["checked"] += 1
                if (out[0] if isinstance(out, tuple) else out).grad_fn is None:
                    record["missing"].append(name)
            return out
        return spy

    spies = {name: make(name) for name in ("flash_attention", "ssm_scan")}

    class Spied:
        def __getattr__(self, name):
            return spies[name] if name in spies else getattr(ops, name)

    kernels_bridge.ops = Spied()
    return record, lambda: setattr(kernels_bridge, "ops", ops)


def train_metrics(training, model, params, seed, steps, device):
    """``steps`` train steps of batch 2 x 32 tokens on the synthetic
    stream; each step's metrics as floats."""
    adamw, data = training.adamw, training.data
    step_fn = training.make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=2))
    state = adamw.init(params)
    out = []
    for b in data.batches(model.cfg, data.DataConfig(batch=2, seq_len=32, seed=seed), steps,
                          device):
        params, state, m = step_fn(params, state, b)
        out.append({k: float(v) for k, v in m.items()})
    return out


# card against CPU, per train step: the kernels' float32 forward differs
# from the plain version within its tolerance, and the embed gradient
# accumulates through the card's atomics, so no step is bit-equal; after
# the first update Adam's m̂/√v̂ ≈ sign(g) can move a parameter whose
# gradient is near 0 by 2·lr, so later steps get ten times the room
TRAIN_RTOL = (1e-4, 1e-3, 1e-3)


def train_parity(torch, ops, kernels_bridge, Model, tree_to, training, cfg, remat, seed,
                 steps=3):
    """Three train steps of a float32 smoke config on the card against the
    same on the CPU, from one init: per-step metrics within TRAIN_RTOL, the
    launches a step implies, and a grad_fn on every kernel output."""
    model = Model(cfg, remat=remat)
    params_cpu = model.init(seed, device="cpu")
    params_gpu = tree_to(params_cpu, "cuda")  # before the CPU steps update in place
    want = train_metrics(training, model, params_cpu, seed, steps, "cpu")
    record, undo = grad_spy(torch, ops, kernels_bridge)
    ops.reset_launches()
    try:
        got = train_metrics(training, model, params_gpu, seed, steps, "cuda")
    finally:
        undo()
    counts = ops.launches()
    expect = {"decode_attention": 0, "flash_attention": steps * attn_layers(cfg, remat),
              "paged_decode_attention": 0, "ssm_scan": steps * mamba_layers(cfg, remat)}
    rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for k in w} for g, w in zip(got, want)]
    ok = all(sorted(g) == sorted(w) for g, w in zip(got, want)) and all(
        max(r.values()) <= tol for r, tol in zip(rel, TRAIN_RTOL))
    phase("train_parity", config=cfg.name, window=cfg.sliding_window, remat=remat,
          steps=steps, cpu_loss=[round(w["loss"], 6) for w in want],
          cuda_loss=[round(g["loss"], 6) for g in got],
          max_rel_diff=[f"{max(r.values()):.2e}" for r in rel],
          worst=[max(r, key=r.get) for r in rel], keys=",".join(sorted(want[0])),
          launches=json.dumps(counts), grad_fn_checked=record["checked"],
          grad_fn_missing=len(record["missing"]))
    if not ok:
        fail(f"{cfg.name} training: the card's metrics differ from the CPU's: {got} vs {want}")
    if counts != expect:
        fail(f"{cfg.name} training: launch counts {counts} != expected {expect}")
    if record["missing"] or record["checked"] != sum(counts.values()):
        fail(f"{cfg.name} training: kernel outputs under grad without a grad_fn: {record}")


# -- phase 5: a main path at full width ---------------------------------------------


def ring_main(torch, ops, Model, long_context_variant, cfg, params, rng, window=512,
              batch=8, S=1024, steps=16):
    """A full-width model's own weights under long_context_variant(window):
    a batch prefill of S tokens (windowed flash attention, ring caches of
    ``window`` rows), then ``steps`` decode steps past the wrap.  Checks
    finite logits, the launch counts and the ring's slot positions;
    returns the counts."""
    model = Model(long_context_variant(cfg, window))
    L = cfg.num_layers
    prompts = rng.integers(1, cfg.vocab_size, size=(batch, S))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        t0 = time.monotonic()
        logits, cache = model.prefill(params, torch.as_tensor(prompts, device="cuda"))
        bad += (~torch.isfinite(logits)).sum()
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        tok = logits[:, 0].argmax(-1)
        t0 = time.monotonic()
        for t in range(steps):
            pos = torch.full((batch,), S + t, dtype=torch.int64, device="cuda")
            logits, cache = model.decode_step(params, cache, tok[:, None], pos)
            bad += (~torch.isfinite(logits)).sum()
            tok = logits[:, 0].argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t0
    counts = ops.launches()
    expect = {"decode_attention": steps * L, "flash_attention": L,
              "paged_decode_attention": 0, "ssm_scan": 0}
    want_pos = torch.arange(S - window, S, dtype=torch.int32, device="cuda")
    want_pos[:steps] = torch.arange(S, S + steps, dtype=torch.int32, device="cuda")
    slots_ok = bool((cache["layers"]["slot_pos"] == want_pos).all().item())
    bad = int(bad.item())
    phase("ring", config=cfg.name, window=window, batch=batch, prefill_tokens=S,
          decode_steps=steps, cache_rows=tuple(cache["layers"]["k"].shape),
          prefill_s=f"{prefill_s:.3f}", decode_ms_per_step=f"{decode_s / steps * 1e3:.2f}",
          peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          launches=json.dumps(counts), expected=json.dumps(expect), slot_pos_ok=slots_ok,
          nonfinite_logits=bad)
    if bad:
        fail(f"{cfg.name} ring: {bad} non-finite logits")
    if counts != expect:
        fail(f"{cfg.name} ring: launch counts {counts} != expected {expect}")
    if not slots_ok:
        fail(f"{cfg.name} ring: slot positions are not the window's last {window}")
    return counts




def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6·N·T for the parameters' products
    (N counts every parameter), and 6·L·H·D·S·T for causal attention over
    L attention layers (forward and backward of Q·Kᵀ and P·V)."""
    T = batch * seq
    return 6.0 * n_params * T + 6.0 * attn_layers(cfg, False) * cfg.num_heads * \
        cfg.head_dim * seq * T


def train_main(torch, ops, Model, flatten, training, cfg, seed, full=None):
    """TRAIN_STEPS train steps of TRAIN_BATCH x TRAIN_SEQ tokens of the
    synthetic stream at full width, bf16, without remat (as the train CLI
    runs):
    step time from CUDA events, tokens/s, peak memory, the loss (it must
    fall) and the model-FLOPs share of the card's bf16 peak.  Returns
    (model, params, state, counts)."""
    adamw, data = training.adamw, training.data
    steps, batch, seq = TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ
    _, params = init_main(torch, Model, flatten, cfg, seed, full=full)
    model = Model(cfg, remat=False)
    n_params = sum(p.numel() for p in flatten(params).values())
    state = adamw.init(params)
    step_fn = training.make_train_step(
        model, adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=max(1, steps // 10)))
    dcfg = data.DataConfig(batch=batch, seq_len=seq, seed=seed)
    batches = [data.synthetic_batch(cfg, dcfg, i, "cuda") for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times, losses = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step_fn(params, state, b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    counts = ops.launches()
    expect = {"decode_attention": 0, "flash_attention": steps * attn_layers(cfg, False),
              "paged_decode_attention": 0, "ssm_scan": steps * mamba_layers(cfg, False)}
    step_ms = float(np.median(times))
    share = train_flops(cfg, n_params, batch, seq) / (step_ms / 1e3 * PEAK_FLOPS["bfloat16"])
    finite = all(math.isfinite(x) for x in losses)
    phase("train", config=cfg.name, layers=cfg.num_layers, params=n_params, batch=batch,
          seq=seq, steps=steps, lr=TRAIN_LR, remat=False, step_ms_p50=f"{step_ms:.2f}",
          step_ms_first=f"{times[0]:.2f}", step_ms_max=f"{max(times):.2f}",
          tokens_per_s=f"{batch * seq / step_ms * 1e3:.0f}",
          peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          weights_grads_moments_gb=f"{n_params * (2 + 2 + 8) / 1e9:.2f}",
          loss=f"{losses[0]:.4f}->{losses[-1]:.4f}",
          losses=",".join(f"{x:.4f}" for x in losses),
          model_flops_share=f"{share:.4f}", launches=json.dumps(counts),
          expected=json.dumps(expect))
    if not finite:
        fail(f"{cfg.name} training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name} training: the loss did not fall: {losses}")
    if counts != expect:
        fail(f"{cfg.name} training: launch counts {counts} != expected {expect}")
    return model, params, state, counts


def init_main(torch, Model, flatten, cfg, seed, full=None):
    """A config's model and its random bf16 weights from ``seed``, on the
    card; ``full``, the uncut config, when ``cfg``'s depth was cut."""
    model = Model(cfg)
    t0 = time.monotonic()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in flatten(params).values())
    cut = {} if full is None else dict(
        depth_cut=f"{full.num_layers}->{cfg.num_layers}",
        full_params=f"{full.param_count():.0f}",
        full_weight_gb=f"{full.param_count() * 2 / 1e9:.2f}")
    phase("init", config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
          dtype=cfg.dtype, params=n_params,
          weight_gb=f"{n_params * 2 / 1e9:.2f}", seconds=f"{time.monotonic() - t0:.1f}",
          **cut)
    return model, params


def phase5_traffic(seed, name):
    """Phase 5's traffic generator for config ``name`` and the prompt
    lengths it draws first (its other draws are the prompts' tokens)."""
    rng = np.random.default_rng([seed, *name.encode()])
    return rng, rng.integers(128, 1025, size=REQUESTS)


def serve_main(torch, ops, Engine, Request, run_closed_loop, measured_for, model, params,
               seed, backend, expect_backend, expect_counts):
    """Serve 16 requests of 128-1024 prompt tokens at full width on
    ``backend``; check the launch counts against ``expect_counts(admissions,
    steps)``; feed the measured throughput into ``measured_for(arch)``, a
    MeasuredProfile round the arch's H100 profile, credited to a whole card
    (size 7), and print the §8.3 correction.  The traffic comes from its
    own generator, seeded by ``seed`` and the config's name, so it does not
    move when other phases draw more or fewer numbers, and two backends of
    one model see the same requests.  Returns (engine, counts, rng)."""
    cfg = model.cfg
    rng, plens = phase5_traffic(seed, cfg.name)

    # warm-up on its own engine (cuBLAS handles, allocator), not counted
    warm = Engine(model, params, batch=2, max_len=256, kv_backend=backend)
    run_closed_loop(warm, [Request(rid=0, prompt=np.arange(1, 40, dtype=np.int32),
                                   max_new_tokens=3)])
    del warm

    engine = Engine(model, params, batch=8, max_len=2048, kv_backend=backend, page_size=16)
    if engine.kv_backend != expect_backend:
        fail(f"{cfg.name}: {backend} backend gave {engine.kv_backend!r}, expected "
             f"{expect_backend!r}")
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, size=int(L)).astype(np.int32),
                    max_new_tokens=NEW_TOKENS) for i, L in enumerate(plens)]
    probe = {"prefill": 0, "prefill_s": 0.0, "decode_s": 0.0,
             "bad": torch.zeros((), dtype=torch.int64, device="cuda")}
    orig_prefill, orig_decode = engine._prefill, engine._decode

    def prefill(*a):
        t = time.monotonic()
        logits, c = orig_prefill(*a)
        probe["bad"] += (~torch.isfinite(logits)).sum()
        torch.cuda.synchronize()
        probe["prefill"] += 1
        probe["prefill_s"] += time.monotonic() - t
        return logits, c

    def decode(*a):
        t = time.monotonic()
        logits, c = orig_decode(*a)
        probe["bad"] += (~torch.isfinite(logits)).sum()
        torch.cuda.synchronize()
        probe["decode_s"] += time.monotonic() - t
        return logits, c

    engine._prefill, engine._decode = prefill, decode
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    measured = measured_for(cfg.name)
    stats = run_closed_loop(engine, reqs, seed=seed, measured=measured, service=cfg.name,
                            size=WHOLE_CARD)
    torch.cuda.synchronize()
    counts = ops.launches()
    engine._prefill, engine._decode = orig_prefill, orig_decode
    bad = int(probe["bad"].item())
    expect = expect_counts(probe["prefill"], engine.steps)
    pct = lambda xs, p: float(np.percentile(xs, p)) if xs else float("nan")  # noqa: E731
    phase("serve", config=cfg.name, backend=engine.kv_backend, served=stats.served,
          requests=len(reqs), tokens=stats.tokens,
          prompt_tokens=int(plens.sum()), admissions=probe["prefill"], steps=engine.steps,
          preempted=stats.preempted, wall_s=f"{stats.wall_s:.3f}",
          throughput_rps=f"{stats.throughput:.3f}",
          tokens_per_s=f"{stats.tokens / stats.wall_s:.1f}",
          prefill_s=f"{probe['prefill_s']:.3f}", decode_s=f"{probe['decode_s']:.3f}",
          ttft_p50_s=f"{pct(stats.ttft_s, 50):.4f}", ttft_p90_s=f"{pct(stats.ttft_s, 90):.4f}",
          tpot_p50_s=f"{pct(stats.tpot_s, 50):.5f}", tpot_p90_s=f"{pct(stats.tpot_s, 90):.5f}",
          peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          launches=json.dumps(counts), expected=json.dumps(expect), nonfinite_logits=bad)
    if stats.served != len(reqs) or not all(r.done for r in reqs):
        fail(f"{cfg.name}: served {stats.served} of {len(reqs)} requests")
    if bad:
        fail(f"{cfg.name}: {bad} non-finite logits on the main path")
    phase("feedback", config=cfg.name, backend=engine.kv_backend, size=WHOLE_CARD,
          batch=engine.batch,
          predicted_rps=f"{measured.predicted(cfg.name, WHOLE_CARD, engine.batch):.3f}",
          measured_rps=f"{stats.throughput:.3f}",
          correction=f"{measured.correction(cfg.name, WHOLE_CARD):.4f}")
    if counts != expect:
        fail(f"{cfg.name}: launch counts {counts} != expected {expect}")
    return engine, counts, rng


# -- phase 7: the dry run against the card; expert parallelism ----------------------

# the steps phase 6 measures, as the dry run prices them on one card: granite-20b's
# flat decode step of 8 slots over 2,048 cache rows, a qwen3-8b admission of 1,024
# tokens, and a qwen3-8b train step of TRAIN_BATCH x TRAIN_SEQ tokens on
# TRAIN_LAYERS layers without remat, as phase 5 trains
CARD_STEPS = (
    ("decode", "granite-20b", "decode:2048:8", ()),
    ("admit", "qwen3-8b", "prefill:1024:1", ()),
    ("train", "qwen3-8b", f"train:{TRAIN_SEQ}:{TRAIN_BATCH}",
     ("--layers", str(TRAIN_LAYERS), "--no-remat")),
)
# the kernel each of those steps must book
CARD_KERNELS = {"decode": "decode_attention", "admit": "flash_attention",
                "train": "flash_attention"}
# one HGX H100 node (8 cards as (data, model) = (2, 4)) at full size
NODE_STEPS = tuple(("qwen3-8b", s, ()) for s in (
    "train_4k", "prefill_32k", "decode_32k", "long_500k")) + (
    ("llama3-405b", "prefill_32k", ()),
    ("deepseek-v3-671b", "decode_32k", ("--moe-shard-map",)),
    ("mamba2-370m", "long_500k", ()),
)
# no count of the work a step needs can take less time than the card took
BOUND_SHARE_MAX = 1.05
DRYRUN_DIR = ROOT / "experiments" / "dryrun_torch"


def dryrun_runs(runs, timeout: float = 600):
    """``python -m repro_torch.launch.dryrun`` once for each argument list,
    all started together: each in a process of its own, since the dry run's
    fake process group must never share a process with a real one.
    Returns each run's JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                               "--out-dir", str(DRYRUN_DIR)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for args in runs]
    try:
        outs = [proc.communicate(timeout=timeout) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    results = []
    for args, proc, (out, err) in zip(runs, procs, outs):
        if proc.returncode != 0:
            fail(f"dry run {' '.join(args)} exited {proc.returncode}:\n{err[-3000:]}")
        line = next(x for x in out.splitlines() if x.startswith("[dryrun]"))
        print(line, flush=True)
        arch = args[args.index("--arch") + 1]
        shape = args[args.index("--shape") + 1].replace(":", "_")
        mesh = args[args.index("--mesh") + 1] if "--mesh" in args else "2x4"
        tag = args[args.index("--tag") + 1]
        results.append(json.loads((DRYRUN_DIR / f"{arch}__{shape}__{mesh}__{tag}.json")
                                  .read_text()))
    return results


def dryrun_card(busy, train_peak_gb: float) -> None:
    """The dry run of the steps phase 6 timed, on the one-card mesh with the
    kernels booked (``--device cuda``): its bound, max(compute, memory) at
    the H100 data sheet's rates, against the step's measured device-busy
    time.  A share above BOUND_SHARE_MAX fails: the count would claim less
    work than the card provably did."""
    t0 = time.monotonic()
    runs = [("--arch", arch, "--shape", shape, "--mesh", "1x1", "--tag", "card", *extra)
            for _, arch, shape, extra in CARD_STEPS]
    for (key, arch, shape, _), d in zip(CARD_STEPS, dryrun_runs(runs)):
        compute_ms, memory_ms = d["compute_s"] * 1e3, d["memory_s"] * 1e3
        bound_ms = max(compute_ms, memory_ms)
        share = bound_ms / busy[key]
        booked = {k: v["calls"] for k, v in d["kernels"].items()}
        extra = {}
        if key == "train":
            extra = dict(dryrun_peak_gb=f"{d['peak_memory_per_device'] / 1e9:.2f}",
                         measured_peak_gb=f"{train_peak_gb:.2f}")
        phase("dryrun", mesh="1x1", step=key, config=arch, shape=shape,
              layers=d["layers"], flops=f"{d['flops_per_device']:.4e}",
              bytes=f"{d['bytes_per_device']:.4e}", compute_ms=f"{compute_ms:.3f}",
              memory_ms=f"{memory_ms:.3f}", bound_ms=f"{bound_ms:.3f}",
              bound_by="operations" if compute_ms >= memory_ms else "bytes",
              busy_ms=f"{busy[key]:.3f}", bound_share=f"{share:.4f}",
              booked=json.dumps(booked), trace_s=f"{d['trace_seconds']:.1f}", **extra)
        if not booked.get(CARD_KERNELS[key]):
            fail(f"dry run of {arch} {shape}: {CARD_KERNELS[key]} was not booked: {booked}")
        if share > BOUND_SHARE_MAX:
            fail(f"dry run of {arch} {shape}: bound {bound_ms:.3f} ms is "
                 f"{share:.3f} of the measured {busy[key]:.3f} ms busy")
    phase("dryrun", mesh="1x1", steps=len(runs), seconds=f"{time.monotonic() - t0:.1f}")


def dryrun_node() -> None:
    """The 8-card node at full size: each step's three terms (seconds at the
    data sheet's rates, NVLink for the collectives) and the dominant one."""
    t0 = time.monotonic()
    runs = [("--arch", arch, "--shape", shape, "--tag", "node", *extra)
            for arch, shape, extra in NODE_STEPS]
    for (arch, shape, extra), d in zip(NODE_STEPS, dryrun_runs(runs)):
        phase("dryrun", mesh="2x4", config=arch, shape=shape,
              moe_shard_map="--moe-shard-map" in extra,
              compute_s=f"{d['compute_s']:.4e}", memory_s=f"{d['memory_s']:.4e}",
              collective_s=f"{d['collective_s']:.4e}", dominant=d["dominant"],
              collectives=json.dumps(d["collective_bytes_by_axis"]),
              peak_gb=f"{d['peak_memory_per_device'] / 1e9:.2f}",
              useful_flops_ratio=f"{d['useful_flops_ratio']:.4f}",
              trace_s=f"{d['trace_seconds']:.1f}")
    phase("dryrun", mesh="2x4", steps=len(runs), seconds=f"{time.monotonic() - t0:.1f}")


def ep_check(torch, get_config, seed, batch: int = 8, seq: int = 128) -> None:
    """deepseek-v2-236b's MoE layer at full width in bf16, random weights
    from ``seed``: ``moe_forward_shard_map`` on a one-rank NCCL group's
    (1, 1) mesh against ``moe_forward`` on the same inputs.  With one rank
    the expert-parallel dispatch routes every token at the same capacity,
    so the two must agree to bf16 rounding (TOL) and the aux loss exactly."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import init_params

    cfg = get_config("deepseek-v2-236b")
    p = init_params(moe_mod.moe_specs(cfg), seed, torch.device("cuda"), torch.bfloat16,
                    stacked=())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = randn(torch, (batch, seq, cfg.d_model), torch.bfloat16, gen)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        with torch.no_grad():
            want, aux_want = moe_mod.moe_forward(p, cfg, x)
            got, aux = moe_mod.moe_forward_shard_map(p, cfg, x, mesh)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            aux_err = abs(float(aux) - float(aux_want))
            ms = cuda_ms(torch, lambda: moe_mod.moe_forward_shard_map(p, cfg, x, mesh), 5)
            plain_ms = cuda_ms(torch, lambda: moe_mod.moe_forward(p, cfg, x), 5)
    finally:
        dist.destroy_process_group()
    phase("ep", config=cfg.name, experts=cfg.num_experts, k=cfg.experts_per_token,
          tokens=batch * seq, d_model=cfg.d_model, dtype="bfloat16", ranks=1,
          max_abs_err=f"{err:.3e}", tol=TOL["bfloat16"], aux=f"{float(aux):.6f}",
          aux_err=f"{aux_err:.3e}", ms=f"{ms:.3f}", moe_forward_ms=f"{plain_ms:.3f}")
    if not (err <= TOL["bfloat16"] and aux_err <= 1e-6 and math.isfinite(err)):
        fail(f"moe_forward_shard_map: max |err| {err:.3e}, aux err {aux_err:.3e}")
    del p, x, got, want



# -- phase 8: the MIG-Serving plan on phase 5's measurements -------------------------

# the architectures phase 5 serves that fit one card, placed onto H100 MIG instances
PLAN_ARCHS = ("qwen3-8b", "mamba2-370m", "zamba2-1.2b", "granite-20b", "phi4-mini-3.8b",
              "internvl2-1b", "musicgen-large")
# the ones no card holds, placed onto groups of cards of one 8-card node
NODE_ARCHS = ("deepseek-v2-236b", "llama3-405b", "deepseek-v3-671b")
# the latency SLO of every service (the reference quickstart's), ms
PLAN_SLO_MS = 100.0
# host seconds phase 8 may take
PLAN_BUDGET_S = 60.0


def recording_profiles(MeasuredProfile, h100_arch_profiles, seen: list):
    """Phase 5's factory of a MeasuredProfile round one architecture's H100
    profile; every observation a serve run feeds it is also appended to
    ``seen`` as (arch, size, batch, measured req/s), for phase 8."""

    class Recording(MeasuredProfile):
        def observe(self, model, size, batch, measured_tput):
            seen.append((model, size, batch, measured_tput))
            super().observe(model, size, batch, measured_tput)

    return lambda arch: Recording(h100_arch_profiles([arch]))


def observe_every_size(prof, arch, size, batch, measured_rps) -> None:
    """Feed ``prof`` one phase-5 observation of ``arch`` (``measured_rps`` on
    a whole card, ``size`` 7, at ``batch``) as the same measured/predicted
    ratio at every size where the model fits.  ``MeasuredProfile`` corrects
    each (model, size) pair on its own, and MIG mode cannot be switched on
    to measure sizes 1-4; a feed at size 7 alone would price the whole card,
    and with it the as-is baseline, at the correction while the MIG sizes
    kept the roofline's rates."""
    ratio = measured_rps / prof.predicted(arch, size, batch)
    for s in prof.sizes():
        b = next((b for b in (batch, 1) if prof.predicted(arch, s, b) > 0), None)
        if b is not None:
            prof.observe(arch, s, b, ratio * prof.predicted(arch, s, b))


def plan_cards(core, rules, prof, wl, seed):
    """The two-phase plan of ``wl`` and its yardsticks: (report, as-is
    whole cards, 4-2-1 static mix or -1, lower bound)."""
    rep = core.TwoPhaseOptimizer(rules, prof, wl, seed=seed).run()
    return (rep, core.baseline_homogeneous(rules, prof, wl, WHOLE_CARD),
            core.baseline_static_mix(rules, prof, wl), core.lower_bound_gpus(rules, prof, wl))


def plan_mig(core, h100_arch_profiles, observations, seed) -> dict:
    """Place the one-card architectures onto H100 MIG instances with the
    two-phase optimizer on phase 5's measured profile, check the plan, then
    move a cluster from it to a night workload with the controller.

    The headline profile gives every size of a model that model's measured
    size-7 correction (``observe_every_size``); the plans on a profile
    corrected at size 7 only, and on the uncorrected roofline, are printed
    beside it for comparison (each at 1-6 times its own size-7 rates).
    Returns the headline profile, the day rates and the day plan."""
    t_phase = time.monotonic()
    base = lambda: h100_arch_profiles(list(PLAN_ARCHS))  # noqa: E731
    prof = core.MeasuredProfile(base())
    only7 = core.MeasuredProfile(base())
    # one observation per model, its first run's (granite-20b's paged one):
    # a second would pull the EWMA correction once more
    first = {}
    for o in observations:
        first.setdefault(o[0], o)
    missing = [a for a in PLAN_ARCHS if a not in first]
    if missing:
        fail(f"plan: phase 5 measured none of {missing}")
    for arch in PLAN_ARCHS:
        observe_every_size(prof, *first[arch])
        only7.observe(*first[arch])
    for arch in PLAN_ARCHS:
        phase("plan", config=arch, classify=prof.classify(arch, PLAN_SLO_MS),
              min_size=prof.min_size(arch),
              correction=json.dumps({s: round(prof.correction(arch, s), 4)
                                     for s in prof.sizes()}),
              rps_by_size=json.dumps({s: round(prof.throughput(arch, s, PLAN_SLO_MS), 3)
                                      for s in prof.sizes()}))
    rng = np.random.default_rng([seed, *b"plan"])
    day_mult = {a: float(rng.uniform(1.0, 6.0)) for a in PLAN_ARCHS}
    night_mult = {a: float(rng.uniform(0.2, 0.45)) for a in PLAN_ARCHS}

    def workloads(p):
        day = {a: p.throughput(a, WHOLE_CARD, PLAN_SLO_MS) * day_mult[a] for a in PLAN_ARCHS}
        night = {a: r * night_mult[a] for a, r in day.items()}
        return [(name, rates, core.Workload.make(
                    {a: core.SLO(r, PLAN_SLO_MS) for a, r in rates.items()}))
                for name, rates in (("day", day), ("night", night))]

    rules = core.h100_mig_rules()
    reps, rates = {}, {}
    for name, r, wl in workloads(prof):
        rep, as_is, mix, lb = plan_cards(core, rules, prof, wl, seed)
        reps[name], rates[name] = rep, r
        best, fast = rep.best_deployment, rep.fast_deployment
        phase("plan", workload=name, rules="h100_mig", correction="every size",
              slo_ms=PLAN_SLO_MS,
              rates_rps=json.dumps({a: round(s.slo.throughput, 3) for a, s in
                                    zip(wl.names, wl.services)}),
              as_is=as_is, static_mix=mix if mix >= 0 else "infeasible",
              greedy=fast.num_gpus, two_phase=best.num_gpus, lower_bound=lb,
              fast_s=f"{rep.fast_seconds:.3f}", total_s=f"{rep.total_seconds:.3f}",
              ga_history=json.dumps(rep.ga_history),
              partitions=json.dumps(sorted(Counter(c.partition for c in best.configs).items())))
        if not best.is_valid(wl):
            fail(f"plan {name}: the two-phase deployment misses an SLO")
        bad = [c.partition for c in best.configs if not rules.is_legal_partition(c.partition)]
        if bad:
            fail(f"plan {name}: illegal partitions {bad}")
        if not lb <= best.num_gpus <= fast.num_gpus:
            fail(f"plan {name}: lower bound {lb} <= two-phase {best.num_gpus} <= greedy "
                 f"{fast.num_gpus} does not hold")
        if best.num_gpus > as_is:
            fail(f"plan {name}: two-phase {best.num_gpus} cards > {as_is} whole cards")
    # for comparison: the same multipliers on a profile corrected at size 7
    # only (the whole card slower than the roofline, its MIG sizes not) and
    # on the uncorrected roofline
    for label, p in (("size 7 only", only7), ("none", base())):
        for name, _, wl in workloads(p):
            rep, as_is, mix, lb = plan_cards(core, rules, p, wl, seed)
            phase("plan", compare=json.dumps(label), plan=name, as_is=as_is,
                  static_mix=mix if mix >= 0 else "infeasible",
                  greedy=rep.fast_deployment.num_gpus, two_phase=rep.best_deployment.num_gpus,
                  lower_bound=lb, partitions=json.dumps(sorted(Counter(
                      c.partition for c in rep.best_deployment.configs).items())))
    day_rates, night_rates = rates["day"], rates["night"]
    # the controller moves a cluster from the day plan to the night plan
    ctrl = core.Controller(rules, prof)
    cluster = core.SimulatedCluster(rules, reps["day"].best_deployment.num_gpus)
    ctrl.deploy_fresh(cluster, reps["day"].best_deployment)
    n0 = len(cluster.trace)
    tr = ctrl.transition(cluster, reps["night"].best_deployment)
    served = Counter((r.size, r.service) for g in cluster.gpus.values()
                     for r in g.instances.values() if r.service)
    want = Counter((a.size, a.service) for c in reps["night"].best_deployment.configs
                   for a in c.assignments if a.service)
    floor = min(tp.get(a, 0.0) / min(day_rates[a], night_rates[a])
                for _, tp in cluster.trace[n0:] for a in PLAN_ARCHS)
    phase("plan", transition="day->night", actions=len(tr.actions),
          counts=json.dumps(tr.action_counts), serial_s=f"{tr.serial_seconds:.1f}",
          parallel_makespan_s=f"{tr.parallel_seconds:.1f}", peak_gpus=tr.peak_gpus_busy,
          final_gpus=tr.final_gpus_busy, min_served_share=f"{floor:.4f}")
    if served != want:
        fail("plan: the cluster's content after the transition is not the night plan")
    if floor < 1.0 - 1e-9:  # §6: each service keeps min(day, night) throughout
        fail(f"plan: a service fell to {floor:.4f} of min(day, night) during the transition")
    phase("plan", mig_seconds=f"{time.monotonic() - t_phase:.2f}")
    return {"profile": prof, "day_rates": day_rates, "night_rates": night_rates,
            "deployment": reps["day"].best_deployment}


def plan_node(core, h100_node_profiles, get_config, seed) -> None:
    """The models no card holds, on groups of 1, 2, 4 or 8 cards of a node:
    deepseek-v2-236b needs all eight, the two larger ones fit no node."""
    prof = h100_node_profiles(list(NODE_ARCHS))
    rules = core.h100_node_rules()
    for arch in NODE_ARCHS:
        gb = get_config(arch).param_count() * 2 / 1e9
        sizes = [s for s in prof.sizes() if prof.feasible(arch, s)]
        phase("plan", node="8xH100", config=arch, weights_gb=f"{gb:.1f}",
              min_size=sizes[0] if sizes else "infeasible on one node")
    if prof.min_size("deepseek-v2-236b") != 56:
        fail(f"plan: deepseek-v2-236b min_size {prof.min_size('deepseek-v2-236b')}, not 56")
    for arch in NODE_ARCHS[1:]:
        if any(prof.feasible(arch, s) for s in prof.sizes()):
            fail(f"plan: {arch} reported feasible on one node")
    rng = np.random.default_rng([seed, *b"node"])
    rate = prof.throughput("deepseek-v2-236b", 56, PLAN_SLO_MS) * float(rng.uniform(1.0, 6.0))
    wl = core.Workload.make({"deepseek-v2-236b": core.SLO(rate, PLAN_SLO_MS)})
    rep = core.TwoPhaseOptimizer(rules, prof, wl, seed=seed).run()
    best = rep.best_deployment
    phase("plan", node="8xH100", config="deepseek-v2-236b", rate_rps=f"{rate:.3f}",
          nodes=best.num_gpus, lower_bound=core.lower_bound_gpus(rules, prof, wl),
          partitions=json.dumps([list(c.partition) for c in best.configs]),
          batch=best.configs[0].assignments[0].batch, total_s=f"{rep.total_seconds:.3f}")
    if not best.is_valid(wl) or any(c.partition != (56,) for c in best.configs):
        fail("plan: deepseek-v2-236b's node deployment is not whole nodes meeting its SLO")


# -- phase 9: the control plane on phase 8's plan (host only) ------------------------

# picks each service's router makes over its instances
ROUTE_PICKS = 20_000
# the fault profiles phase 9 reconciles the day plan under
CONTROL_FAULTS = ("none", "gpu_loss", "instance_crash")
# sim seconds the fault injector spreads its device faults over (an hour)
CONTROL_DURATION_S = 3600.0
# host seconds phase 9 may take
CONTROL_BUDGET_S = 30.0


def route_plan(router_mod, prof, deployment) -> list:
    """One weighted router per service of ``deployment``, each instance
    weighted by ``prof``'s throughput at its size and batch; returns, per
    service, (service, weights, picks per instance) after ROUTE_PICKS picks."""
    members = {}
    for c in deployment.configs:
        for a in c.assignments:
            if a.service:
                members.setdefault(a.service, []).append(a)
    out = []
    for svc in sorted(members):
        handles = [router_mod.InstanceHandle(
                       instance_id=i, size=a.size,
                       throughput=a.batch * 1000.0 / prof.latency_ms(svc, a.size, a.batch))
                   for i, a in enumerate(members[svc])]
        router = router_mod.WeightedRouter(handles)
        for _ in range(ROUTE_PICKS):
            router.pick()
        counts = router.dispatch_counts()
        out.append((svc, [h.throughput for h in handles], [counts[h.instance_id]
                                                             for h in handles]))
    return out


def fire_device_fault(injector, cluster, fault):
    """Fire one of the injector's scheduled device faults on ``cluster``, its
    target drawn by the injector over sorted candidates: a GPU failure on a
    busy card and a drain of a machine with a busy card, as the simulator
    draws them; an instance crash on any serving instance (its process
    restarts in place: the cluster keeps the instance).  The simulator
    draws a crash among the instances with work in flight (a fluid
    backlog, or requests in the token model), which a cluster that serves
    no traffic does not have; phase 10 runs the simulator's own draw.
    Returns (target, instances killed), or None when nothing is busy."""
    busy = [gid for gid, g in cluster.gpus.items() if g.busy() and gid not in cluster.failed]
    if fault.kind == "gpu_failure":
        gid = injector.pick_gpu(busy)
        return None if gid is None else (gid, len(cluster.fail_gpu(gid)))
    if fault.kind == "node_drain":
        machine = injector.pick_machine(sorted({cluster.gpus[g].machine for g in busy}))
        if machine is None:
            return None
        cluster.drain_machine(machine)
        return machine, 0
    if fault.kind == "instance_crash":
        uid = injector.pick_instance(sorted(cluster.busy_instances()))
        return None if uid is None else (uid, 0)
    raise ValueError(fault.kind)


def control_run(core, controlplane, obs_mod, rules, prof, deployment, required, fault,
                seed) -> dict:
    """Reconcile ``deployment`` onto a fresh cluster under the ``fault``
    profile, fire the injector's device faults, and reconcile again after
    the profile's detection delay, recording spans and metrics in sim time.
    Package-agnostic (``core``, ``controlplane`` and ``obs_mod`` are either
    package's), so the tests run it on both."""
    obs = obs_mod.Observability.on()
    ctrl = core.Controller(rules, prof)
    plane = controlplane.build_control_plane(ctrl, fault, seed, CONTROL_DURATION_S)
    cluster = core.SimulatedCluster(rules, deployment.num_gpus)
    desired = controlplane.DesiredState(deployment, dict(required))
    passes, fired = [], []

    def reconcile(label, t0):
        obs.tracer.begin("reconcile", label, t0)
        rep, stats = plane.reconciler.reconcile(cluster, desired)
        t1 = t0 + rep.parallel_seconds
        for a in rep.actions:
            obs.metrics.counter(f"actions.{a.kind}").inc()
        obs.metrics.counter("reconcile.iterations").inc(stats.iterations)
        obs.metrics.counter("reconcile.retried").inc(stats.retried)
        obs.metrics.gauge("gpus.busy").set(cluster.gpus_in_use())
        obs.tracer.end("reconcile", t1, args={"actions": len(rep.actions),
                                              "converged": stats.converged})
        obs.metrics.sample(t1)
        passes.append({"pass": label, "stats": stats.to_dict(), "actions": len(rep.actions),
                       "counts": rep.action_counts, "makespan_s": rep.parallel_seconds,
                       "serial_s": rep.serial_seconds})
        return t1

    t = reconcile("deploy", 0.0)
    for f in plane.injector.device_faults() if plane.injector is not None else ():
        t = max(t, f.time_s)
        hit = fire_device_fault(plane.injector, cluster, f)
        obs.tracer.instant("faults", f.kind, t, args={"target": hit and hit[0]})
        obs.metrics.counter(f"faults.{f.kind}").inc()
        fired.append({"kind": f.kind, "time_s": f.time_s, "hit": hit})
    # level-triggered: a converged cluster makes the second pass a no-op
    reconcile("repair", t + plane.profile.detection_delay_s)
    obs.tracer.assert_well_formed()
    return {
        "passes": passes, "faults": fired,
        "converged": controlplane.diff(controlplane.ObservedState.observe(cluster),
                                       desired).converged,
        "partitions": {gid: g.partition() for gid, g in sorted(cluster.gpus.items())},
        "failed": sorted(cluster.failed), "draining": sorted(cluster.draining),
        "actions": [dataclasses.astuple(a) for a in cluster.actions_applied],
        "metrics": obs.metrics.snapshot(), "spans": obs.tracer.span_summary(),
        "trace": obs.tracer.export_json(),
    }


def token_model_rps(core, sim, profiles, cfg, measured_rps, batch, prompt_tokens,
                    page_size=16, max_len=2048) -> tuple:
    """The token-level serving model of ``cfg`` on a whole card, on the
    profile a MeasuredProfile (ewma 1.0) corrects with the engine's measured
    requests/s, at phase 5's geometry: ``batch`` slots, ``REQUESTS``
    requests of ``prompt_tokens`` and ``NEW_TOKENS`` arriving at once, the
    engine's page pool.  Returns (the model's requests/s, its pages)."""
    name = cfg.name
    prof = core.MeasuredProfile(profiles([name]), ewma=1.0)
    prof.observe(name, WHOLE_CARD, batch, measured_rps)
    per_page = sim.servemodel.page_bytes(page_size, cfg.num_kv_heads, cfg.head_dim,
                                         cfg.num_layers)
    pages = batch * -(-max_len // page_size)  # the engine's pool: every slot at max_len
    knobs = sim.TokenKnobs(
        prompt_tokens=prompt_tokens, decode_tokens=NEW_TOKENS,
        profiled_decode_tokens=NEW_TOKENS, max_len=max_len, page_size=page_size,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, n_layers=cfg.num_layers,
        hbm_gb_per_unit=(pages + 0.5) * per_page / WHOLE_CARD / 2**30,
        prefill_chunk=prompt_tokens)
    state = sim.TokenServingState([name], prof, lambda s: 1e9, knobs)
    inst = sim.InstanceModel(0, name, WHOLE_CARD, slots=batch, knobs=knobs,
                             step_time_s=state.step_time_for(name, WHOLE_CARD), now=0.0)
    for i in range(REQUESTS):
        inst.queue.append(sim.TokenRequest(i, name, 0.0, prompt_tokens, NEW_TOKENS))
    inst.run_until(1e9, state.metrics)
    done = state.metrics.completed_at[name]
    if len(done) != REQUESTS:
        fail(f"token: the model finished {len(done)} of {REQUESTS} requests")
    return REQUESTS / max(done), knobs.num_pages(WHOLE_CARD)


def control_phase(core, controlplane, obs_mod, router_mod, sim, profiles, get_config, plan,
                  observations, seed) -> None:
    """Phase 9: route, reconcile under faults and model the tokens of phase
    8's day plan on phase 5's measured profile (host only)."""
    rules, prof = core.h100_mig_rules(), plan["profile"]
    dep, required = plan["deployment"], plan["day_rates"]
    for svc, weights, counts in route_plan(router_mod, prof, dep):
        total = sum(weights)
        err = max(abs(c / ROUTE_PICKS - w / total) for w, c in zip(weights, counts))
        tol = len(weights) / ROUTE_PICKS + 1e-3
        phase("route", service=svc, instances=len(weights), picks=ROUTE_PICKS,
              weights_rps=json.dumps([round(w, 3) for w in weights]),
              dispatched=json.dumps(counts), max_share_err=f"{err:.6f}", bound=f"{tol:.6f}")
        if err > tol:
            fail(f"route {svc}: a share is {err:.6f} off its weight share, over {tol:.6f}")
    for fault in CONTROL_FAULTS:
        res = control_run(core, controlplane, obs_mod, rules, prof, dep, required, fault, seed)
        for p in res["passes"]:
            phase("control", fault=fault, step=p["pass"], stats=json.dumps(p["stats"]),
                  actions=p["actions"], counts=json.dumps(p["counts"]),
                  makespan_s=f"{p['makespan_s']:.1f}", serial_s=f"{p['serial_s']:.1f}")
        bad = [p for p in res["partitions"].values() if not rules.is_legal_partition(p)]
        phase("control", fault=fault, faults=json.dumps(res["faults"]),
              converged=res["converged"], cards=len(res["partitions"]),
              failed=json.dumps(res["failed"]), illegal=len(bad),
              spans=res["spans"]["events"], metrics=json.dumps(res["metrics"]))
        if not res["converged"]:
            fail(f"control {fault}: the cluster did not converge to the day plan")
        if bad:
            fail(f"control {fault}: illegal partitions {bad} on h100_mig_rules()")
    qwen = get_config("qwen3-8b")
    obs7 = next(o for o in observations if o[0] == qwen.name)
    _, plens = phase5_traffic(seed, qwen.name)
    prompt = int(round(float(plens.mean())))
    model_rps, pages = token_model_rps(core, sim, profiles, qwen, obs7[3], obs7[2], prompt)
    phase("token", config=qwen.name, size=WHOLE_CARD, batch=obs7[2], requests=REQUESTS,
          prompt_tokens=prompt, new_tokens=NEW_TOKENS, pages=pages,
          engine_rps=f"{obs7[3]:.4f}", model_rps=f"{model_rps:.4f}",
          rel_err=f"{abs(model_rps - obs7[3]) / obs7[3]:.4f}")


# -- phase 10: the closed-loop simulator on phase 8's measurements (host only) -------

# the fault profiles phase 10 runs the loop under (each on the fluid model)
SIM_FAULTS = ("none", "gpu_loss")
# sim seconds of each half of the trace (the day rates, then the night ones)
SIM_HALF_S = 3600.0
SIM_BIN_S = 60.0
# the reoptimize cadence, s (the reference's SimConfig default)
SIM_REOPTIMIZE_S = 1800.0
# host seconds phase 10 may take
SIM_BUDGET_S = 60.0


def sim_trace(sim, day_rates, night_rates):
    """An hour of ``day_rates`` then an hour of ``night_rates`` (requests/s
    by service), replayed in SIM_BIN_S bins."""
    n = int(SIM_HALF_S / SIM_BIN_S)
    return sim.replay_trace({a: np.concatenate([np.full(n, day_rates[a]),
                                                np.full(n, night_rates[a])])
                             for a in sorted(day_rates)}, bin_s=SIM_BIN_S)


def sim_run(core, sim, prof, day_rates, night_rates, fault, seed):
    """One closed loop of the day-then-night trace on ``prof`` over
    ``h100_mig_rules()``; returns (the simulator, its report)."""
    cfg = sim.SimConfig(reoptimize_every_s=SIM_REOPTIMIZE_S, latency_slo_ms=PLAN_SLO_MS,
                        seed=seed, fault_profile=fault)
    s = sim.ClusterSimulator(core.h100_mig_rules(), prof,
                             sim_trace(sim, day_rates, night_rates), cfg)
    return s, s.run()


def sim_phase(core, sim, plan, seed) -> None:
    """Phase 10: the paper's closed loop on phase 8's measured profile and
    day and night rates, under each of SIM_FAULTS, each run twice."""
    prof, day, night = plan["profile"], plan["day_rates"], plan["night_rates"]
    for fault in SIM_FAULTS:
        t0 = time.monotonic()
        s, rep = sim_run(core, sim, prof, day, night, fault, seed)
        host_s = time.monotonic() - t0
        again = sim_run(core, sim, prof, day, night, fault, seed)[1]
        same = again.to_json() == rep.to_json()
        sat = {a: rep.slo_satisfaction(a) for a in rep.services}
        att = {a: rep.mean_attainment(a) for a in rep.services}
        peak = max([rep.final_gpus] + [n for t in rep.transitions
                                       for n in (t.gpus_before, t.gpus_after)])
        # as-is: whole cards for the trace's peak rates, under the loop's
        # headroom and SLO (as the scenario matrix counts it)
        peak_rates = {a: float(s.trace.rates[a].max()) for a in s.trace.services}
        as_is = core.baseline_homogeneous(s.rules, s.profile, s.driver.workload_for(peak_rates),
                                          s.rules.device_size)
        bad = [g.partition() for g in s.cluster.gpus.values()
               if not s.rules.is_legal_partition(g.partition())]
        extra = {}
        if fault != "none":
            rec = rep.recovery_time_s()
            extra = dict(faults=len(rep.faults), availability=f"{rep.availability():.4f}",
                         recovery_s="none" if rec is None else f"{rec:.1f}")
        phase("sim", fault=fault, serving_model=s.config.serving_model,
              slo_satisfaction=json.dumps({a: round(v, 4) for a, v in sat.items()}),
              mean_attainment=json.dumps({a: round(v, 4) for a, v in att.items()}),
              gpus_final=rep.final_gpus, gpus_peak=peak, as_is=as_is,
              transitions=len(rep.transitions), reoptimize_checks=rep.reoptimize_checks,
              makespan_s=json.dumps([round(t.parallel_seconds, 1) for t in rep.transitions]),
              transparent=rep.transparent, **extra, illegal=len(bad), same_bytes=same,
              report_sha256=hashlib.sha256(rep.to_json().encode()).hexdigest()[:16],
              host_s=f"{host_s:.2f}")
        if not same:
            fail(f"sim {fault}: a second run with seed {seed} gave other report bytes")
        if bad:
            fail(f"sim {fault}: illegal partitions {bad} on h100_mig_rules()")
        if not all(math.isfinite(v) for v in [*sat.values(), *att.values()]):
            fail(f"sim {fault}: an attainment is not finite")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.monotonic()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        from repro_torch.configs import get_config, get_smoke_config, long_context_variant
        from repro_torch import controlplane, core, sim
        from repro_torch import obs as obs_mod
        from repro_torch.core.arch_bridge import h100_arch_profiles, h100_node_profiles
        from repro_torch.core.online_profiles import MeasuredProfile
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import decode_attention as dec_mod
        from repro_torch.kernels import flash_attention as fa_mod
        from repro_torch.kernels import paged_attention as paged_mod
        from repro_torch.kernels import ssm_scan as ssm_mod
        from repro_torch import training
        from repro_torch.models import Model, kernels_bridge
        from repro_torch.models.common import flatten, tree_to, unflatten
        from repro_torch.serving import Engine, Request, router, run_closed_loop
    except ImportError as e:
        fail(f"cannot import the port (run from the root of a checkout): {e}")
    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", name=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          tf32="off (matmul and cudnn)")
    print(smi.stdout.strip(), flush=True)  # the card's name and power limit, as is

    # 2. build ----------------------------------------------------------------
    t0 = time.monotonic()
    _build.build_all()
    phase("build", seconds=f"{time.monotonic() - t0:.1f}", dir=_build.build_dir(),
          arch="sm_90a", kernels=",".join(_build.KERNELS))
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    for name in _build.KERNELS:  # tensor-core instructions in the machine code
        hmma = sum("HMMA" in line for line in _build.sass(name).splitlines())
        phase("sass", kernel=name, hmma=hmma)
        if hmma == 0:
            fail(f"{name}: no HMMA instruction in its library")

    # 3. kernels against their plain versions, at the main paths' shapes -------
    rng = np.random.default_rng(args.seed)
    qwen, mamba, zamba, granite = (
        get_config(a) for a in ("qwen3-8b", "mamba2-370m", "zamba2-1.2b", "granite-20b"))
    results = {}
    for S in (128, 1024):  # prompt buckets: one chunk, and the longest prompt
        for cfg in (mamba, zamba):
            results[("ssm", cfg.name, S)] = check_ssm(torch, ops, ssm_mod, rng, cfg, S)
    for dtype in (torch.float32, torch.bfloat16):
        r = check_paged(torch, ops, paged_mod, dtype, rng, qwen, batch=8, max_len=2048,
                        page_size=16)
        results[("paged", dtype)] = r
        for S in (16, 48, 512, 2048):
            for window in (None, S // 3 + 1):
                r = check_flash(torch, ops, fa_mod, dtype, rng, qwen, S, window)
                results[("flash", dtype, S, window)] = r
        # zamba2's shared attention: head dim 64, one query head per kv head
        check_paged(torch, ops, paged_mod, dtype, rng, zamba, batch=8, max_len=2048,
                    page_size=16)
        for S in (128, 1024):
            check_flash(torch, ops, fa_mod, dtype, rng, zamba, S, None)
    # granite-20b: 48 query heads over one KV head: its prefill, the ring
    # phase's windowed batch-8 prefill, paged and flat decode; qwen3-8b flat
    results["flash_granite"] = check_flash(torch, ops, fa_mod, torch.bfloat16, rng, granite,
                                           1024, None)
    results["flash_ring"] = check_flash(torch, ops, fa_mod, torch.bfloat16, rng, granite, 1024,
                                        512, B=8)
    check_paged(torch, ops, paged_mod, torch.bfloat16, rng, granite, batch=8, max_len=2048,
                page_size=16)
    results["decode"] = check_decode(torch, ops, dec_mod, torch.bfloat16, rng, granite, 8, 2048)
    check_decode(torch, ops, dec_mod, torch.bfloat16, rng, granite, 8, 2048, window=512)
    check_decode(torch, ops, dec_mod, torch.float32, rng, granite, 8, 2048)
    check_decode(torch, ops, dec_mod, torch.bfloat16, rng, qwen, 8, 2048)
    # head_dim 16 (phi4-mini's smoke heads, G = 3) in both dtypes; phi4-mini's
    # (G = 3) and internvl2-1b's (G = 7) full shapes
    phi4, intern, music = (
        get_config(a) for a in ("phi4-mini-3.8b", "internvl2-1b", "musicgen-large"))
    d16 = get_smoke_config("phi4-mini-3.8b")
    for dtype in (torch.float32, torch.bfloat16):
        check_flash(torch, ops, fa_mod, dtype, rng, d16, 512, None)
        check_paged(torch, ops, paged_mod, dtype, rng, d16, batch=8, max_len=2048,
                    page_size=16)
        check_decode(torch, ops, dec_mod, dtype, rng, d16, 8, 2048)
        for cfg in (phi4, intern):
            check_paged(torch, ops, paged_mod, dtype, rng, cfg, batch=8, max_len=2048,
                        page_size=16)
    for cfg in (phi4, intern):
        check_flash(torch, ops, fa_mod, torch.bfloat16, rng, cfg, 1024, None)
        check_decode(torch, ops, dec_mod, torch.bfloat16, rng, cfg, 8, 2048)
    # the gradients that training takes through flash and the scan, at the
    # training cell's shapes (qwen3-8b's heads over 4 x 1,024 tokens in
    # bf16, mamba2-370m's in float32), a float32 smoke shape and a window;
    # from their own generator, so the draws above and below do not move
    grad_rng = np.random.default_rng([args.seed, 3])
    results["flash_grad"] = check_flash_grad(torch, ops, fa_mod, torch.bfloat16, grad_rng,
                                             4, 1024, qwen.num_heads, qwen.num_kv_heads,
                                             qwen.head_dim, None)
    check_flash_grad(torch, ops, fa_mod, torch.float32, grad_rng, 2, 64, 4, 2, 32, None)
    check_flash_grad(torch, ops, fa_mod, torch.bfloat16, grad_rng, 1, 1024, qwen.num_heads,
                     qwen.num_kv_heads, qwen.head_dim, 256)
    results["scan_grad"] = check_scan_grad(torch, ops, ssm_mod, grad_rng, 4, 1024,
                                           mamba.ssm_heads, mamba.ssm_head_dim,
                                           mamba.ssm_state, mamba.ssm_chunk)

    # 4. whole-path parity: the card's kernels against the CPU's plain path ----
    # the deepseek-v2 smoke config with GQA in place of MLA: MoE blocks
    # between flash and the paged or flat decode kernels
    gqa_moe = dataclasses.replace(get_smoke_config("deepseek-v2-236b", dtype="float32"),
                                  attention_kind="gqa", name="deepseek-v2-smoke-gqa")
    parity_runs = [(get_smoke_config(arch, dtype="float32"), backend) for arch, backend in (
        ("qwen3-8b", "paged"), ("qwen3-8b", "flat"), ("mamba2-370m", "flat"),
        ("zamba2-1.2b", "paged"), ("zamba2-1.2b", "flat"), ("granite-20b", "paged"),
        ("granite-20b", "flat"), ("phi4-mini-3.8b", "paged"), ("phi4-mini-3.8b", "flat"),
        ("llama3-405b", "paged"), ("llama3-405b", "flat"), ("internvl2-1b", "paged"),
        ("internvl2-1b", "flat"), ("musicgen-large", "paged"), ("musicgen-large", "flat"),
        ("deepseek-v2-236b", "flat"), ("deepseek-v3-671b", "flat"))]
    parity_runs += [(gqa_moe, "paged"), (gqa_moe, "flat")]
    for scfg, backend in parity_runs:
        smodel = Model(scfg)
        params_cpu = smodel.init(args.seed, device="cpu")
        params_gpu = tree_to(params_cpu, "cuda")
        prompts = [rng.integers(1, scfg.vocab_size, size=L).astype(np.int32)
                   for L in (3, 5, 9)]
        want = staggered_tokens(Engine, Request, smodel, params_cpu, prompts, 6, backend)
        ops.reset_launches()
        got = staggered_tokens(Engine, Request, smodel, params_gpu, prompts, 6, backend)
        counts = ops.launches()
        # MLA is plain torch, as in the reference: it launches no kernel
        attends = scfg.arch_type != "ssm" and scfg.attention_kind == "gqa"
        uses = {"decode_attention": attends and backend == "flat",
                "flash_attention": attends,
                "paged_decode_attention": attends and backend == "paged",
                "ssm_scan": scfg.arch_type in ("ssm", "hybrid")}
        phase("parity", config=scfg.name, backend=backend, cpu_tokens=want, cuda_tokens=got,
              launches=json.dumps(counts))
        if got != want:
            fail(f"{scfg.name} {backend}: the card's out_tokens differ from the CPU's")
        if any(counts[k] == 0 for k, used in uses.items() if used):
            fail(f"{scfg.name} {backend}: parity run did not launch every kernel it uses: "
                 f"{counts}")
        if any(counts[k] for k, used in uses.items() if not used):
            fail(f"{scfg.name} {backend}: parity run launched a kernel it does not use: "
                 f"{counts}")
    for arch in ("qwen3-8b", "deepseek-v2-236b"):
        ring_parity(torch, ops, Model, tree_to, get_smoke_config, long_context_variant, rng,
                    args.seed, arch)
    # training on the card against the CPU: every family, the stub frontend's
    # embeddings, and GQA under a window shorter than the sequence
    smoke = {a: get_smoke_config(a, dtype="float32") for a in (
        "qwen3-8b", "granite-20b", "mamba2-370m", "zamba2-1.2b", "deepseek-v3-671b",
        "internvl2-1b")}
    for arch, remat in (("qwen3-8b", False), ("granite-20b", False), ("mamba2-370m", True),
                        ("zamba2-1.2b", True), ("deepseek-v3-671b", True),
                        ("internvl2-1b", False)):
        train_parity(torch, ops, kernels_bridge, Model, tree_to, training, smoke[arch], remat,
                     args.seed)
    train_parity(torch, ops, kernels_bridge, Model, tree_to, training,
                 long_context_variant(smoke["qwen3-8b"], window=8), True, args.seed)

    # 5. main paths at full width, each followed by its profile (6) -----------------
    observed = []  # every run's §8.3 observation, for phase 8's plan
    serve = (torch, ops, Engine, Request, run_closed_loop,
             recording_profiles(MeasuredProfile, h100_arch_profiles, observed))
    counts = []
    model, params = init_main(torch, Model, flatten, qwen, args.seed)
    engine, c, rng = serve_main(
        *serve, model, params, args.seed, "auto", "paged",
        lambda admits, steps: {"decode_attention": 0,
                               "flash_attention": admits * qwen.num_layers,
                               "paged_decode_attention": steps * qwen.num_layers,
                               "ssm_scan": 0})
    counts.append(c)
    profile_decode(torch, engine, qwen, rng, Request)
    busy = {"admit": profile_prefill(
        torch, engine, qwen, rng, Request,
        {"flash_attention": ("flash_mma_kernel", "flash_attention_kernel"),
         "matmul": MATMUL_NAMES})}
    del engine, model, params
    torch.cuda.empty_cache()

    model, params = init_main(torch, Model, flatten, mamba, args.seed)
    engine, c, rng = serve_main(
        *serve, model, params, args.seed, "auto", "flat",
        lambda admits, steps: {"decode_attention": 0, "flash_attention": 0,
                               "paged_decode_attention": 0,
                               "ssm_scan": admits * mamba.num_layers})
    counts.append(c)
    profile_prefill(torch, engine, mamba, rng, Request,
                    {"ssm_scan": ("chunk_cb", "chunk_state", "state_pass", "chunk_scan"),
                     "matmul": MATMUL_NAMES})
    del engine, model, params
    torch.cuda.empty_cache()

    n_attn = zamba.num_layers // zamba.shared_attn_every
    model, params = init_main(torch, Model, flatten, zamba, args.seed)
    _, c, _ = serve_main(
        *serve, model, params, args.seed, "auto", "paged",
        lambda admits, steps: {"decode_attention": 0, "flash_attention": admits * n_attn,
                               "paged_decode_attention": steps * n_attn,
                               "ssm_scan": admits * zamba.num_layers})
    counts.append(c)
    del model, params, _
    torch.cuda.empty_cache()

    # granite-20b: 40.6 GB of weights, drawn once every earlier model is freed
    phase("memory", before=granite.name,
          allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    model, params = init_main(torch, Model, flatten, granite, args.seed)
    L = granite.num_layers
    _, c, _ = serve_main(
        *serve, model, params, args.seed, "auto", "paged",
        lambda admits, steps: {"decode_attention": 0, "flash_attention": admits * L,
                               "paged_decode_attention": steps * L, "ssm_scan": 0})
    counts.append(c)
    del _
    engine, c, rng = serve_main(
        *serve, model, params, args.seed, "flat", "flat",
        lambda admits, steps: {"decode_attention": steps * L, "flash_attention": admits * L,
                               "paged_decode_attention": 0, "ssm_scan": 0})
    counts.append(c)
    busy["decode"] = profile_decode(torch, engine, granite, rng, Request)
    del engine
    torch.cuda.empty_cache()
    counts.append(ring_main(torch, ops, Model, long_context_variant, granite, params, rng))
    del model, params
    torch.cuda.empty_cache()

    # the dense stack at three more shapes: phi4-mini (G = 3, vocab 200,064),
    # internvl2-1b (G = 7) and musicgen-large (G = 1, vocab 2,048)
    for cfg in (phi4, intern, music):
        model, params = init_main(torch, Model, flatten, cfg, args.seed)
        L = cfg.num_layers
        _, c, _ = serve_main(
            *serve, model, params, args.seed, "auto", "paged",
            lambda admits, steps, L=L: {"decode_attention": 0, "flash_attention": admits * L,
                                        "paged_decode_attention": steps * L, "ssm_scan": 0})
        counts.append(c)
        del model, params, _
        torch.cuda.empty_cache()

    # deepseek-v2-236b at full width, depth cut to DSV2_LAYERS: MLA on the
    # flat latent cache and the routed experts are plain torch, as in the
    # reference, so the run launches none of the four kernels
    dsv2_full = get_config("deepseek-v2-236b")
    dsv2 = get_config("deepseek-v2-236b", num_layers=DSV2_LAYERS)
    phase("memory", before=dsv2.name,
          allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    model, params = init_main(torch, Model, flatten, dsv2, args.seed, full=dsv2_full)
    engine, c, rng = serve_main(
        *serve, model, params, args.seed, "auto", "flat",
        lambda admits, steps: {"decode_attention": 0, "flash_attention": 0,
                               "paged_decode_attention": 0, "ssm_scan": 0})
    counts.append(c)
    profile_decode(torch, engine, dsv2, rng, Request,
                   {"matmul": MATMUL_NAMES,
                    "moe_dispatch": ("index", "radix", "cub", "scatter", "gather")})
    del engine, model, params
    torch.cuda.empty_cache()

    # training at full width: qwen3-8b cut to TRAIN_LAYERS, then mamba2-370m whole
    qwen_train = get_config("qwen3-8b", num_layers=TRAIN_LAYERS)
    phase("memory", before=f"training {qwen_train.name}",
          allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    model, params, state, c = train_main(torch, ops, Model, flatten, training, qwen_train,
                                         args.seed, full=qwen)
    counts.append(c)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy["train"] = profile_train(torch, training, flatten, unflatten, model, params, state,
                                  args.seed)
    del model, params, state
    torch.cuda.empty_cache()
    phase("memory", before=f"training {mamba.name}",
          allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
    *_, c = train_main(torch, ops, Model, flatten, training, mamba, args.seed)
    counts.append(c)
    del _
    torch.cuda.empty_cache()

    # 7. the dry run against the card's measured steps; expert parallelism --------
    dryrun_card(busy, train_peak_gb)
    dryrun_node()
    ep_check(torch, get_config, args.seed)

    # 8. the MIG-Serving plan on phase 5's measurements (host only) -----------------
    t0 = time.monotonic()
    plan = plan_mig(core, h100_arch_profiles, observed, args.seed)
    plan_node(core, h100_node_profiles, get_config, args.seed)
    plan_s = time.monotonic() - t0
    phase("plan", host_seconds=f"{plan_s:.2f}", budget_s=PLAN_BUDGET_S)
    if plan_s > PLAN_BUDGET_S:
        fail(f"plan: {plan_s:.1f} s of host time, over {PLAN_BUDGET_S} s")

    # 9. the control plane on phase 8's day plan (host only) ------------------------
    t0 = time.monotonic()
    control_phase(core, controlplane, obs_mod, router, sim, h100_arch_profiles, get_config,
                  plan, observed, args.seed)
    control_s = time.monotonic() - t0
    phase("control", host_seconds=f"{control_s:.2f}", budget_s=CONTROL_BUDGET_S)
    if control_s > CONTROL_BUDGET_S:
        fail(f"control: {control_s:.1f} s of host time, over {CONTROL_BUDGET_S} s")

    # 10. the closed-loop simulator on phase 8's measurements (host only) -----------
    t0 = time.monotonic()
    sim_phase(core, sim, plan, args.seed)
    sim_s = time.monotonic() - t0
    phase("sim", host_seconds=f"{sim_s:.2f}", budget_s=SIM_BUDGET_S)
    if sim_s > SIM_BUDGET_S:
        fail(f"sim: {sim_s:.1f} s of host time, over {SIM_BUDGET_S} s")

    phase("done", seconds=f"{time.monotonic() - t_start:.1f}")
    # launches: the sum over the main-path runs (each counted from 0)
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    summary = {"kernels": [
        dict(name="decode_attention", route="cuda", source=DECODE_SOURCE,
             replaces=DECODE_REPLACES, launches=launches["decode_attention"],
             **results["decode"]),
        dict(name="flash_attention", route="cuda", source=FLASH_SOURCE,
             replaces=FLASH_REPLACES, launches=launches["flash_attention"],
             **results[("flash", torch.bfloat16, 512, None)]),
        dict(name="paged_decode_attention", route="cuda", source=PAGED_SOURCE,
             replaces=PAGED_REPLACES, launches=launches["paged_decode_attention"],
             **results[("paged", torch.bfloat16)]),
        dict(name="ssm_scan", route="cuda", source=SSM_SOURCE, replaces=SSM_REPLACES,
             launches=launches["ssm_scan"], **results[("ssm", mamba.name, 1024)]),
    ]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def kernel_families(events, families):
    """Device time (us) of the profiler's kernel rows by family:
    ``families`` maps a family to name fragments; the rest is "other".
    Returns (times, kernel count)."""
    from torch.autograd import DeviceType

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]  # not the ops
    out = {f: 0.0 for f in families}
    out["other"] = 0.0
    for e in kernels:
        name = e.key.lower()
        fam = next((f for f, frags in families.items() if any(w in name for w in frags)),
                   "other")
        out[fam] += e.self_device_time_total
    return out, sum(e.count for e in kernels)


MATMUL_NAMES = ("gemm", "gemv", "nvjet", "cutlass", "sm90_xmma")


DECODE_FAMILIES = {"decode_attention": ("decode_split", "decode_merge_kernel"),
                   "paged_attention": ("paged_split", "paged_merge"),
                   "matmul": MATMUL_NAMES}


def profile_decode(torch, engine, cfg, rng, Request, families=DECODE_FAMILIES,
                   steps: int = 8) -> float:
    """Fill every slot, time ``steps`` decode steps on the host clock, then
    trace as many more with torch.profiler: device time by kernel family
    (``families`` as kernel_families takes them), the device's idle share
    of the untraced step time, and the top rows of the profiler's table."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(engine.batch):
        L = int(rng.integers(128, 1025))
        engine.admit(Request(rid=10_000 + i, max_new_tokens=2 * steps + 4,
                             prompt=rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)))
    engine.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    families, n_kernels = kernel_families(events, families)
    busy_ms = sum(families.values()) / steps / 1e3
    phase("profile", config=cfg.name, steps=steps, batch=engine.batch, step_ms=f"{step_ms:.3f}",
          device_busy_ms_per_step=f"{busy_ms:.3f}",
          device_idle_share=f"{max(0.0, 1 - busy_ms / step_ms):.3f}",
          **{f"{k}_ms_per_step": f"{v / steps / 1e3:.3f}" for k, v in families.items()},
          kernels_per_step=n_kernels // steps)
    print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    while engine.num_live:
        engine.step()
    return busy_ms


def profile_prefill(torch, engine, cfg, rng, Request, families, L: int = 1024) -> float:
    """One admission of an ``L``-token prompt timed on the host clock, then
    another traced with torch.profiler: device time by kernel family
    (``families`` as kernel_families takes them), the device's idle share of
    the untraced admission, kernels per prefill."""
    from torch.profiler import ProfilerActivity, profile

    def admit(rid):
        prompt = rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)
        engine.admit(Request(rid=rid, prompt=prompt, max_new_tokens=1))  # done at admission
        torch.cuda.synchronize()

    admit(20_000)  # warm: this prompt length's allocations
    t0 = time.monotonic()
    admit(20_001)
    admit_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        admit(20_002)
    events = prof.key_averages()
    families, n_kernels = kernel_families(events, families)
    busy_ms = sum(families.values()) / 1e3
    phase("profile", config=cfg.name, prefill_tokens=L, admit_ms=f"{admit_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          device_idle_share=f"{max(0.0, 1 - busy_ms / admit_ms):.3f}",
          **{f"{k}_ms": f"{v / 1e3:.3f}" for k, v in families.items()},
          kernels_per_prefill=n_kernels)
    print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)
    engine.step()  # hand back the finished requests
    return busy_ms


TRAIN_FAMILIES = {"flash_attention": ("flash_mma_kernel", "flash_attention_kernel"),
                  "attn_softmax": ("softmax",), "matmul": MATMUL_NAMES}


def profile_train(torch, training, flatten, unflatten, model, params, state, seed,
                  families=TRAIN_FAMILIES) -> float:
    """One train step split by CUDA events into its forward (the loss),
    backward (autograd, the plain attention recompute included) and
    optimizer (the AdamW leaf loop), then one more step timed on the host
    clock and one traced with torch.profiler: device time by kernel family
    (the softmax kernels are the plain attention recompute's, as nothing
    else in a dense step takes a softmax), the idle share, kernels."""
    from torch.profiler import ProfilerActivity, profile

    data = training.data
    opt_cfg = training.adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    batch = data.synthetic_batch(model.cfg, data.DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed),
                                 TRAIN_STEPS, "cuda")
    loss_fn = training.make_loss_fn(model)
    flat = flatten(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
    with torch.enable_grad():
        loss, _ = loss_fn(unflatten(leaves), batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    ev[2].record()
    del leaves, loss
    _, state, _ = training.adamw.update(opt_cfg, unflatten(dict(zip(flat, grads))), state,
                                        params)
    ev[3].record()
    ev[3].synchronize()
    del grads
    parts = {n: ev[i].elapsed_time(ev[i + 1])
             for i, n in enumerate(("forward", "backward", "optimizer"))}
    step_fn = training.make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params, state, _ = step_fn(params, state, batch)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    fams, n_kernels = kernel_families(events, families)
    busy_ms = sum(fams.values()) / 1e3
    if not n_kernels:
        fail(f"{model.cfg.name}: the traced train step ran no kernel on the device")
    phase("profile", config=model.cfg.name, train_step_tokens=int(batch["labels"].numel()),
          **{f"{k}_ms": f"{v:.2f}" for k, v in parts.items()}, step_ms=f"{step_ms:.2f}",
          device_busy_ms=f"{busy_ms:.2f}",
          device_idle_share=f"{max(0.0, 1 - busy_ms / step_ms):.3f}",
          **{f"{k}_ms": f"{v / 1e3:.2f}" for k, v in fams.items()},
          kernels_per_step=n_kernels)
    print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    return busy_ms


if __name__ == "__main__":
    main()
