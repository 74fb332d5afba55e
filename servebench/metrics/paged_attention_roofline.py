"""Paged decode attention's share of its roofline in the traced decode
steps, in %: each step's counted work (counts/kernels.py over the live
slots' contexts, one call a layer) at the card's peaks, over the device
time of the paged split and merge kernels in the trace."""

from servebench import counts
from servebench.counts import kernels

NAMES = ("paged_split", "paged_merge")


def read(run):
    cfg = run.cfg
    calls = [c for c in run.steps if c.traced and c.lens]
    if (run.trace is None or not calls or cfg["arch_type"] != "dense"
            or run.workload["engine"]["kv_backend"] != "paged"):
        return None
    device = run.trace.device_s(NAMES)
    if device <= 0:
        return None
    H, KV = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // H
    ps = run.workload["engine"]["page_size"]
    layers = counts.family(cfg).attention_layers(cfg)
    bound = sum(counts.seconds(*kernels.paged_attention(c.lens, H, KV, hd, ps)) for c in calls)
    return 100.0 * layers * bound / device
