"""Fused RMSNorm (kernel B3): the CUDA kernel's wrapper and its plain
PyTorch version.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel in
``csrc/rmsnorm.cu`` or raises. There is no fallback between the two. Under
autograd the backward is a kernel too (``csrc/rmsnorm_bwd.cu``,
``rmsnorm_backward``), whose plain version is the closed form
``rmsnorm_bwd`` and, for its two-pass dw, ``rmsnorm_dw_partials``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_dtensor

_DTYPES = (torch.float32, torch.bfloat16)
N_SMS = 132                          # H100 SXM


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
    runs inside ``_RMSNorm``, whose backward is the backward kernel
    (``rmsnorm_backward``); otherwise
    it launches bare, and the host work of a call is kept under
    F.rms_norm's: after the checks, one allocation and a launch through
    the library's CPython binding (which raises on a CUDA error) on the
    raw handle of the current stream. A DTensor is refused with a
    TypeError (``refuse_dtensor``)."""
    refuse_dtensor("rmsnorm", x, w, residual)
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
    """B3 under autograd: the kernel's forward, and the backward kernel
    (``rmsnorm_backward``). The reference has no backward kernel: its
    gradient is XLA's autodiff of the jnp norm, outside Pallas."""

    @staticmethod
    def forward(ctx, x, w, residual, eps):
        y = _launch(x, w, residual, eps)
        ctx.save_for_backward(x, w, residual)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, residual = ctx.saved_tensors
        return (*rmsnorm_backward(x, w, dy.contiguous(), residual, ctx.eps),
                None)


def bwd_ctas(rows: int) -> int:
    """The backward kernel's CTAs: three an SM (its block of up to 256
    threads keeps a row in registers), at most one a row. CTA c takes rows
    c, c + C, ... and writes its partial dw to row c of a (C, d) scratch."""
    return max(1, min(rows, 3 * N_SMS))


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     eps: float = 1e-5):
    """(dx, dw, dresidual) from the backward kernel
    (``csrc/rmsnorm_bwd.cu``) on CUDA tensors; dresidual is dx itself (None
    without a residual). Counts its launch in ``rmsnorm_backward.launches``.
    Its plain version is ``rmsnorm_bwd``; a shape the kernel does not take
    raises, and nothing falls back."""
    refuse_dtensor("rmsnorm_backward", x, w, dy, residual)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_backward: unsupported device {x.device}")
    _check(x, w, residual)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError("rmsnorm_backward: dy must be a contiguous tensor "
                         "of x's shape, dtype and device")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if d > (16384 if x.dtype is torch.bfloat16 else 8192):
        raise ValueError(f"rmsnorm_backward: d {d} over the kernel's row "
                         "of 2048 16-byte vectors")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w) if rows else torch.zeros_like(w)
    if rows:
        ctas = bwd_ctas(rows)
        part = torch.empty((ctas, d), dtype=torch.float32, device=x.device)
        _build.module().rmsnorm_bwd(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            part.data_ptr(), rows, d, ctas, eps, x.dtype is torch.bfloat16,
            w.dtype is torch.bfloat16,
            torch._C._cuda_getCurrentRawStream(x.get_device()))
    rmsnorm_backward.launches += 1
    return dx, dw, None if residual is None else dx


def rmsnorm_dw_partials(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        eps: float = 1e-5, ctas: Optional[int] = None):
    """The backward kernel's two-pass dw in plain PyTorch: the (C, d) fp32
    partials, row c the sum of dy * x^ over rows c, c + C, ... (C =
    ``bwd_ctas(rows)`` unless given), and dw, their sum by column, in w's
    type."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    if residual is not None:
        xf = xf + residual.float().reshape(-1, d)
    rows = xf.shape[0]
    ctas = bwd_ctas(rows) if ctas is None else ctas
    xhat = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    terms = dy.float().reshape(-1, d) * xhat
    part = torch.zeros((ctas, d), dtype=torch.float32, device=x.device)
    part.index_add_(0, torch.arange(rows, device=x.device) % ctas, terms)
    return part, part.sum(dim=0).to(w.dtype)


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
rmsnorm_backward.launches = 0

__all__ = ["rmsnorm", "rmsnorm_backward", "rmsnorm_bwd", "rmsnorm_ref",
           "rmsnorm_dw_partials", "bwd_ctas"]
