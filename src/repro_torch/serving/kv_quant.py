"""int8 KV-cache quantization (KIVI/KVQuant-style, per-token-per-head scales),
rewritten in torch from the reference ``repro.serving.kv_quant``.

Serving-side lever on the paper's Eq. 5-6: halving KV bytes doubles each
worker's capacity M, which moves the KV-bound branch of T_max and therefore
the optimal worker configuration — ``optimal_worker_config`` accepts
``kv_dtype_bytes`` to reflect it. As in the reference, the engine does not
call these functions; its KV pool stays fp32.

Every step is the reference's in fp32 (``torch.round`` rounds half to even
as ``jnp.round`` does), so the results agree bit for bit."""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 values, fp32 scales (..., 1)); symmetric
    per-vector (token x head) scaling — the D axis shares one scale."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    scale = m / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def kv_quant_error(x: torch.Tensor) -> float:
    """Max relative reconstruction error (diagnostics)."""
    q, s = quantize_kv(x)
    back = dequantize_kv(q, s)
    denom = torch.clamp(x.abs().max(), min=1e-9)
    return float((back - x.float()).abs().max() / denom)
