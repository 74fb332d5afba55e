"""Parameter trees <-> ``.npz`` files, in the JAX package's layout.

The port of the JAX package's ``training/checkpoint.py``: one array per
leaf under its ``/``-joined key path (``layers/attn/wq``), bf16 stored as
float32 (npz has no bf16).  The layout is the reference's, so its
``restore`` reads a checkpoint saved here and :func:`restore` reads one
saved there.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import flatten, unflatten


def save(path: str, tree: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for key, leaf in flatten(tree).items():
        t = leaf.detach().cpu()
        flat[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.savez_compressed(path, **flat)


def restore(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """The tree saved at ``path``, each leaf checked against the shape of
    ``like``'s and cast to its dtype, on its device."""
    out = {}
    with np.load(path) as data:
        for key, leaf in flatten(like).items():
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, expected "
                                 f"{tuple(leaf.shape)}")
            out[key] = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return unflatten(out)
