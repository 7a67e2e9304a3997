"""Shared model building blocks (plain functions on tensors).

``rms_norm`` dispatches by the tensor's device: the CUDA kernel B3 for a
CUDA tensor, its plain version for a CPU tensor. A failing kernel raises;
nothing falls back. On a DTensor it runs on each rank's rows through
``local_map``: rows are independent, so the local call is exact."""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.rmsnorm import rmsnorm


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast to x's type. A
    DTensor x keeps its rows' layout; a pending sum is reduced and a
    sharded last dim gathered first (GSPMD gathers it too); w is
    replicated."""
    if not isinstance(x, DTensor):
        return rmsnorm(x, w, eps=eps)
    rows = tuple(Replicate() if pl.is_partial() or pl.is_shard(x.ndim - 1)
                 else pl for pl in x.placements)
    return local_map(lambda x_, w_: rmsnorm(x_, w_, eps=eps),
                     out_placements=list(rows),
                     in_placements=(rows, (Replicate(),) * len(rows)),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    if angles.dim() == 2:         # (S, half) -> broadcast over batch
        angles = angles[None]
    angles = angles[..., :, None, :]                   # (B, S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(S,) or (B, S) -> (..., S, d_model) sinusoidal embedding (fp32)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the reference's op order (x / (1 + exp(-x)) as
    jax.nn.silu lowers it), so bf16 rounds at the same places."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _const(v: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d constant, made once a (value, dtype, device): a copy from the
    host on every call would keep a CUDA graph from capturing the call.
    Made outside inference mode, so that autograd may save it later."""
    with torch.inference_mode(False):
        return torch.tensor(v, dtype=dtype, device=device)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (tanh form) op for op, constants in x's dtype (kept
    for a plain tensor; a fake tensor or a DTensor makes its own)."""
    def c(v):
        if type(x) is torch.Tensor:
            return _const(v, x.dtype, x.device)
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = x + c(0.044715) * (x * x * x)
    return x * (c(0.5) * (1.0 + torch.tanh(c(math.sqrt(2 / math.pi))
                                           * inner)))


def gated_mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
              wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``silu``) or GeGLU (``gelu``, tanh form)."""
    actf = _silu if act == "silu" else _gelu_tanh
    return (actf(x @ wi_gate) * (x @ wi_up)) @ wo
