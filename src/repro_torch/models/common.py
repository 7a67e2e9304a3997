"""Shared model building blocks (plain functions on tensors).

``rms_norm`` dispatches by the tensor's device: the CUDA kernel B3 for a
CUDA tensor, its plain version for a CPU tensor. A failing kernel raises;
nothing falls back."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.rmsnorm import rmsnorm


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast to x's type."""
    return rmsnorm(x, w, eps=eps)


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


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (tanh form) op for op, constants in x's dtype."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = x + c(0.044715) * (x * x * x)
    return x * (c(0.5) * (1.0 + torch.tanh(c(math.sqrt(2 / math.pi))
                                           * inner)))


def gated_mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
              wo: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``silu``) or GeGLU (``gelu``, tanh form)."""
    actf = _silu if act == "silu" else _gelu_tanh
    return (actf(x @ wi_gate) * (x @ wi_up)) @ wo
