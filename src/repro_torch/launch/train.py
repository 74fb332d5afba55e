"""Training driver.

The port of the JAX package's ``launch/train.py``: the same options and
``REPRO_100M`` config, plus ``--device`` (default ``cuda``; pass
``--device cpu`` to run without a card).  Weights are random, from
``--seed``; the data is :mod:`repro_torch.training.data`'s synthetic
stream.  On a card the forward runs the flash and scan kernels, and
their backward is the plain version's gradient.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen3-8b \\
      --smoke --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --repro-100m --steps 10
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models.common import flatten, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.training import adamw, checkpoint, data, make_train_step

# ~100M-parameter dense config for the end-to-end training example
REPRO_100M = ModelConfig(
    name="repro-100m",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=8192,
    citation="in-repo 100M example config",
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--repro-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.repro_100m:
        cfg = REPRO_100M
    elif args.arch:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    else:
        cfg = get_smoke_config("qwen3-8b")
    device = resolve_device(args.device)

    model = Model(cfg, remat=False)
    params = model.init(args.seed, device=device)
    n_params = sum(p.numel() for p in flatten(params).values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10))
    opt_state = adamw.init(params)
    step_fn = make_train_step(model, opt_cfg)
    dcfg = data.DataConfig(batch=args.batch, seq_len=args.seq, seed=args.seed)

    t0 = time.monotonic()
    first = last = None
    for i, batch in enumerate(data.batches(cfg, dcfg, args.steps, device)):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks/dt:.0f} tok/s, loss {first:.3f} -> {last:.3f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, params)
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
