"""The SSD chunked scan's share of its roofline in the traced admissions,
in %: the calls' counted work (counts/kernels.py at the true prompt
lengths, float32 products at the TF32 peak, one call a layer) over the
device time of the scan's four forward kernels in the trace."""

from servebench import counts
from servebench.counts import kernels

NAMES = ("chunk_cb_kernel", "chunk_state_kernel", "state_pass_kernel", "chunk_scan_kernel")


def read(run):
    cfg = run.cfg
    calls = [c for c in run.admits if c.traced]
    if run.trace is None or not calls or cfg["arch_type"] != "ssm":
        return None
    device = run.trace.device_s(NAMES)
    if device <= 0:
        return None
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    H = cfg["ssm_expand"] * cfg["d_model"] // P
    bound = sum(counts.seconds(*kernels.ssm_scan(c.lens[0], H, P, N, cfg["ssm_chunk"]))
                for c in calls)
    return 100.0 * cfg["num_layers"] * bound / device
