"""Hand-written Hopper kernels of the port, one per TPU kernel on the
serving path and one for the Scenario API's compiled simulation core, each
beside its plain PyTorch version:

  rmsnorm/           B3, fused RMSNorm (+ residual), and its backward
                     kernel (training)
  flash_attention/   B2, GQA flash-attention forward (prefill, chunked
                     prefill, training), and its backward kernel
  decode_attention/  B1, paged decode attention over the engine's page pool
  ssd_scan/          B4, Mamba-2 SSD chunked scan (prefill, and training
                     with a backward kernel)
  fastsim/           the whole-trace heartbeat loop of ``engine="jax"``
                     (``serving/fastsim_jax.py``)

CUDA sources live under each ``csrc/``; ``_build`` compiles them with nvcc
at first use and imports the library as a CPython extension module. A wrapper runs its plain
version for CPU tensors and its kernel for CUDA tensors, with no fallback.
"""
from torch.distributed.tensor import DTensor


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a DTensor: a kernel
    takes one rank's local shard, which ``local_map`` hands it (a DTensor
    passes ``is_cuda`` but has no local storage to launch on)."""
    for t in tensors:
        if type(t) is DTensor:
            raise TypeError(f"{name}: got a DTensor; call it on each rank's "
                            "local shard (local_map)")
