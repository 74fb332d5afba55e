"""Synthetic deterministic data pipeline.

The port of the JAX package's ``training/data.py``: a batch is a pure
function of (seed, step), from the same numpy stream as the reference's,
so both packages train on identical batches.  Sequences follow an affine
next-token rule, so the loss falls within a few steps.  Stub-modality
architectures (vlm, audio) get frontend embeddings instead of tokens: a
fixed seeded table looked up by the underlying tokens, rounded to bf16 as
the reference rounds them, whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Union

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.models.config import ModelConfig

Device = Union[str, torch.device]


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


def synthetic_batch(
    cfg: ModelConfig, data: DataConfig, step: int, device: Device = "cuda"
) -> Dict[str, torch.Tensor]:
    """One batch on ``device``: ``labels`` and ``tokens`` (int64), or
    ``labels`` and ``embeds`` (bf16) for a stub modality."""
    dev = resolve_device(device)
    rng = np.random.default_rng(data.seed * 1_000_003 + step)
    # x_{t+1} = (a·x_t + c) mod V from random starts
    V = cfg.vocab_size
    a, c = 31, 17
    start = rng.integers(0, V, size=(data.batch, 1), dtype=np.int64)
    seq = np.zeros((data.batch, data.seq_len + 1), np.int64)
    seq[:, 0:1] = start
    for t in range(data.seq_len):
        seq[:, t + 1] = (a * seq[:, t] + c) % V
    tokens, labels = seq[:, :-1], seq[:, 1:]
    out = {"labels": torch.as_tensor(labels, device=dev)}
    if cfg.modality == "text":
        out["tokens"] = torch.as_tensor(tokens, device=dev)
    else:
        trng = np.random.default_rng(data.seed + 7)
        tab = trng.standard_normal(size=(min(V, 1024), cfg.d_model)).astype(np.float32)
        emb = torch.as_tensor(tab[tokens % tab.shape[0]])
        out["embeds"] = emb.to(torch.bfloat16).to(dev)
    return out


def batches(
    cfg: ModelConfig, data: DataConfig, steps: int, device: Device = "cuda"
) -> Iterator[Dict[str, torch.Tensor]]:
    for step in range(steps):
        yield synthetic_batch(cfg, data, step, device)
