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

    On CUDA, when grad mode is on and an input requires grad, the kernel
    runs inside ``_RMSNorm``, whose backward is ``rmsnorm_bwd``; otherwise
    it launches bare, and the host work of a call is kept under
    F.rms_norm's: after the checks, one allocation and a launch through
    the library's CPython binding (which raises on a CUDA error) on the
    raw handle of the current stream."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, residual, eps)
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (residual is not None and residual.requires_grad)):
        return _RMSNorm.apply(x, w, residual, eps)
    return _launch(x, w, residual, eps)


def _launch(x, w, residual, eps) -> torch.Tensor:
    """Check the inputs, launch the CUDA kernel and count the launch."""
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


class _RMSNorm(torch.autograd.Function):
    """B3 under autograd: the kernel's forward, and ``rmsnorm_bwd``
    (PyTorch ops) as its backward. The reference has no backward kernel:
    its gradient is XLA's autodiff of the jnp norm, outside Pallas."""

    @staticmethod
    def forward(ctx, x, w, residual, eps):
        y = _launch(x, w, residual, eps)
        ctx.save_for_backward(x, w, residual)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, residual = ctx.saved_tensors
        return (*rmsnorm_bwd(x, w, dy, residual, ctx.eps), None)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                eps: float = 1e-5):
    """Gradients (dx, dw, dresidual) of ``rmsnorm_ref`` in closed form, in
    fp32, returned in the inputs' types (dresidual is None without a
    residual): with x' = x + residual, rstd = rsqrt(mean(x'^2) + eps),
    x^ = x' * rstd and g = dy * w,
    dx = rstd * (g - x^ * mean(g * x^)), dw = sum over rows of dy * x^,
    and the residual gets dx."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    dyf = dy.float()
    g = dyf * w.float()
    dxf = rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return (dxf.to(x.dtype), dw.to(w.dtype),
            None if residual is None else dxf.to(residual.dtype))


rmsnorm.launches = 0

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_ref"]
