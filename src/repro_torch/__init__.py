"""PyTorch/CUDA port of the MIG-Serving serving stack for one NVIDIA H100.

A second package beside the JAX reference (``repro``), importing nothing
of it.  It serves dense GQA models (qwen3-8b) through the same entry points:
:class:`repro_torch.serving.Engine` (``admit`` runs a batch-1 prefill into
pages, ``step`` runs ragged paged decode), :func:`repro_torch.serving.run_closed_loop`
and ``python -m repro_torch.launch.serve``.  Both attention kernels on that
path are hand-written CUDA C++ for ``sm_90a`` (:mod:`repro_torch.kernels`);
every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
