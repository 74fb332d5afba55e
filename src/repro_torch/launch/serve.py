"""Serve CLI: a model in an :class:`Engine`, a stream of requests,
throughput and latency, and the paper's §8.3 feedback.

The port of the JAX package's ``launch/serve.py``: its options and
``--stats-json`` schema, plus ``--device`` (default ``cuda``; pass
``--device cpu`` to run without a card) and ``--no-smoke`` for the full
model.  Weights are random, from ``--seed``.  The measured throughput is
fed into a :class:`~repro_torch.core.online_profiles.MeasuredProfile`
wrapped round the H100 MIG roofline profile of ``--arch`` (the full
config's), credited to an instance of ``--size`` of the card's 7 compute
slices (default 7, the whole card), and the correction is printed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --requests 16 --batch 4 --new-tokens 8             # smoke config
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
      --batch 8 --prompt-len 512 --new-tokens 64 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --device cpu                                       # SSM smoke config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --device cpu                                       # hybrid smoke config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-20b \\
      --device cpu --backend flat                        # MQA smoke config, flat KV
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-20b --no-smoke \\
      --backend flat --batch 8 --max-len 2048            # 20 B parameters, one card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \\
      --device cpu --size 3                              # vlm smoke config, 3g profile
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --device cpu                                       # MoE + MLA smoke config, flat KV

MLA models (deepseek-v2-236b, deepseek-v3-671b) serve on the flat latent
cache only: ``--backend auto`` takes it and ``--backend paged`` fails.
Their full configs, like llama3-405b's, fit no card, and the profile
prices the full config, so their §8.3 correction stays 1.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.arch_bridge import h100_arch_profiles
from repro_torch.core.online_profiles import MeasuredProfile
from repro_torch.models import Model
from repro_torch.roofline.hw import MIG_MEMORY_SLICES
from repro_torch.serving import Engine, Request, run_closed_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="reduced smoke config (--no-smoke: the full model)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--backend", choices=["auto", "flat", "paged"], default="auto")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--size", type=int, choices=sorted(MIG_MEMORY_SLICES), default=7,
                    help="H100 MIG instance size (compute slices of 7) credited in the "
                         "§8.3 profile feedback; 7 is the whole card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--stats-json", type=str, default=None, metavar="PATH",
                    help="write engine TTFT/TPOT stats as JSON in the same "
                         "metrics schema as the reference's serve CLI")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    params = model.init(args.seed, device=args.device)
    engine = Engine(
        model, params, batch=args.batch, max_len=args.max_len,
        kv_backend=args.backend, page_size=args.page_size,
        temperature=args.temperature, top_k=args.top_k,
    )

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(1, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for i in range(args.requests)
    ]
    measured = MeasuredProfile(h100_arch_profiles([args.arch]))
    stats = run_closed_loop(
        engine, reqs, seed=args.seed,
        measured=measured, service=args.arch, size=args.size,
    )
    lat = [r.finished_s - r.submitted_s for r in reqs]
    print(
        f"arch={cfg.name} device={engine.device} backend={engine.kv_backend} "
        f"served={stats.served} tokens={stats.tokens} preempted={stats.preempted} "
        f"wall={stats.wall_s:.2f}s tput={stats.throughput:.2f} req/s "
        f"p50_lat={np.percentile(lat, 50)*1e3:.0f}ms p90_lat={np.percentile(lat, 90)*1e3:.0f}ms"
    )
    if engine.pool is not None:
        print(
            f"pages={engine.pool.num_pages} free={engine.pool.free_pages} "
            f"page_size={engine.pool.page_size}"
        )
    print(
        f"§8.3 feedback: measured correction for ({args.arch}, size={args.size}) "
        f"= {measured.correction(args.arch, args.size):.4f}"
    )
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats.summary(args.arch), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"stats written to {args.stats_json}")


if __name__ == "__main__":
    main()
