"""Hand-written Hopper kernels of the port, one per TPU kernel on the
serving path and one for the Scenario API's compiled simulation core, each
beside its plain PyTorch version:

  rmsnorm/           B3, fused RMSNorm (+ residual)
  flash_attention/   B2, GQA flash-attention forward (prefill, chunked
                     prefill)
  decode_attention/  B1, paged decode attention over the engine's page pool
  ssd_scan/          B4, Mamba-2 SSD chunked scan (prefill)
  fastsim/           the whole-trace heartbeat loop of ``engine="jax"``
                     (``serving/fastsim_jax.py``)

CUDA sources live under each ``csrc/``; ``_build`` compiles them with nvcc
at first use and imports the library as a CPython extension module. A wrapper runs its plain
version for CPU tensors and its kernel for CUDA tensors, with no fallback.
"""
