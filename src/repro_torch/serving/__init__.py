"""Serving runtime: the per-instance engine, its page pool and the
service-level router.

The engine pulls in torch and the models; the page pool and the router
are plain Python.  The engine's names are exported lazily (PEP 562), so
torch-free consumers (the token serving model in :mod:`repro_torch.sim`)
import the page pool and the router without torch.
"""

from repro_torch.serving.paged_cache import OutOfPages, PagePool
from repro_torch.serving.router import InstanceHandle, WeightedRouter

__all__ = [
    "Engine", "InstanceHandle", "OutOfPages", "PagePool", "Request",
    "ServeStats", "WeightedRouter", "attn_layer_count", "page_hbm_bytes",
    "run_closed_loop",
]

_ENGINE_NAMES = ("Engine", "Request", "ServeStats", "attn_layer_count",
                 "page_hbm_bytes", "run_closed_loop")


def __getattr__(name):
    if name in _ENGINE_NAMES:
        from repro_torch.serving import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
