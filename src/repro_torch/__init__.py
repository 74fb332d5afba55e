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
"""
