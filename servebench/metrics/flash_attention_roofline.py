"""Flash attention's share of its roofline in the traced admissions, in %:
the calls' counted work (counts/kernels.py, at the true prompt lengths,
one call a layer) at the card's peaks, over the device time of the
forward flash kernels in the trace."""

from servebench import counts
from servebench.counts import kernels

NAMES = ("flash_wgmma_kernel", "flash_mma_kernel", "flash_attention_kernel")


def read(run):
    cfg = run.cfg
    calls = [c for c in run.admits if c.traced]
    if run.trace is None or not calls or cfg["arch_type"] != "dense":
        return None
    device = run.trace.device_s(NAMES)
    if device <= 0:
        return None
    H, KV = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // H
    layers = counts.family(cfg).attention_layers(cfg)
    bound = sum(counts.seconds(*kernels.flash_attention(c.lens[0], H, KV, hd)) for c in calls)
    return 100.0 * layers * bound / device
