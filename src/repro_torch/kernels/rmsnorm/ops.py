"""Fused RMSNorm (kernel B3): the CUDA kernel's wrapper and its plain
PyTorch version.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel in
``csrc/rmsnorm.cu`` or raises. There is no fallback between the two."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                eps: float = 1e-5) -> torch.Tensor:
    """y = rmsnorm(x + residual) * w, computed in fp32, cast to x's type."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor,
           residual: Optional[torch.Tensor]) -> None:
    """Raise for what the kernel does not take; return for what it does."""
    d = x.shape[-1]
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}/{w.dtype} not in "
                        f"{_DTYPES}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} on {w.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError("rmsnorm: residual must be a contiguous tensor of "
                         "x's shape, dtype and device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            residual: Optional[torch.Tensor] = None, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,); optional residual like x. See rmsnorm_ref.

    On CUDA the host work of a call is kept under F.rms_norm's: after the
    checks, one allocation and a launch through the library's CPython
    binding (which raises on a CUDA error) on the raw handle of the
    current stream."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, residual, eps)
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _check(x, w, residual)
    d = x.shape[-1]
    y = torch.empty_like(x)
    # torch._C._cuda_getCurrentRawStream (private; PyTorch's generated
    # Triton launchers read the stream through it) gives the handle as an
    # int without building a torch.cuda.Stream
    _build.module().rmsnorm(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        w.data_ptr(), y.data_ptr(), x.numel() // d if d else 0, d, eps,
        x.dtype is torch.bfloat16, w.dtype is torch.bfloat16,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0

__all__ = ["rmsnorm", "rmsnorm_ref"]
