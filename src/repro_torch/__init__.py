"""PyTorch/CUDA port of the MIG-Serving serving stack for one NVIDIA H100.

A second package beside the JAX reference (``repro``), importing nothing
of it.  It serves the architectures of :mod:`repro_torch.configs` (dense,
MoE with MLA, SSM, hybrid, vlm and audio) through the same entry points:
:class:`repro_torch.serving.Engine` (``admit`` runs a batch-1 prefill into
pages, ``step`` runs ragged paged decode), :func:`repro_torch.serving.run_closed_loop`
and ``python -m repro_torch.launch.serve``.  The kernels on those paths
are hand-written CUDA C++ for ``sm_90a`` (:mod:`repro_torch.kernels`);
every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
:mod:`repro_torch.core` holds MIG-Serving itself: the rule-sets, the
performance profiles over H100 MIG instances with their §8.3 online
correction, the two-phase optimizer and the controller that places the
served models onto H100 MIG instances (or groups of cards of a node).
:mod:`repro_torch.sim` is the closed-loop cluster simulator of the paper's
Figures 13-14 over those pieces; it is re-exported here lazily (PEP 562, as
the reference does), so ``import repro_torch`` loads neither torch nor the
simulator.
"""

__all__ = [
    "ClusterSimulator", "ReoptimizeDriver", "SimConfig", "SimReport",
    "Trace", "diurnal_trace", "flash_crowd_trace", "poisson_burst_trace",
    "replay_trace",
]


def __getattr__(name):
    if name in __all__:
        from repro_torch import sim

        return getattr(sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
