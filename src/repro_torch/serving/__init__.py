"""Serving runtime: the per-instance engine and its page pool."""

from repro_torch.serving.engine import (
    Engine, Request, ServeStats, attn_layer_count, page_hbm_bytes, run_closed_loop,
)
from repro_torch.serving.paged_cache import OutOfPages, PagePool

__all__ = [
    "Engine", "OutOfPages", "PagePool", "Request", "ServeStats",
    "attn_layer_count", "page_hbm_bytes", "run_closed_loop",
]
