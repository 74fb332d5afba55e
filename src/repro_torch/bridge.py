"""Load weights saved in the JAX package's flat layout into the port.

The JAX checkpoint layout is a dict of ``/``-joined key paths to numpy
arrays (``embed``, ``layers/attn/wq``, ...; bf16 leaves stored as
float32).  :func:`params_from_jax` maps such a dict onto the port's nested
params, checking that every key the model needs is there with the right
shape and that nothing is left over.  The port never imports the JAX
package: the caller flattens on that side.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.models.common import DTYPES, resolve_device, unflatten
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model


def params_from_jax(
    flat: Dict[str, np.ndarray],
    cfg: ModelConfig,
    device: Union[str, torch.device] = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Nested torch params for ``cfg`` from a flat ``{key path: array}``
    dict, on ``device`` in ``dtype`` (default: the config's).  bf16 goes
    through float32, since numpy has no bf16 of its own."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else DTYPES[cfg.dtype]
    specs = Model(cfg).param_specs()
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise ValueError(f"{cfg.name}: missing keys {missing}, unexpected keys {extra}")
    out = {}
    for key, (shape, *_) in specs.items():
        arr = np.asarray(flat[key], np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(shape)}")
        # a copy: the source array may be read-only (a view of a jax array)
        out[key] = torch.tensor(arr).to(device=dev, dtype=dtype)
    return unflatten(out)
