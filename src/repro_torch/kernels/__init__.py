"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas kernel
of the JAX package that the port's path runs, each beside its plain
PyTorch version:

  * ``decode_attention`` — one-token decode over a flat KV cache with a
    validity mask (``csrc/decode_attention.cu``)
  * ``flash_attention``  — causal prefill attention (``csrc/flash_attention.cu``)
  * ``paged_attention``  — one-token decode over a paged KV pool
    (``csrc/paged_attention.cu``)
  * ``ssm_scan``         — the Mamba2 SSD chunked scan (``csrc/ssm_scan.cu``)

and two that replace no Pallas kernel, the serving paths' RMSNorm (with its
residual add) and rotary embedding in one pass each (``norm_rope``,
``csrc/norm_rope.cu``).

:mod:`repro_torch.kernels.ops` holds the public wrappers; the kernels are
compiled by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`), never
at import.
"""
