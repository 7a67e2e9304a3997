"""Self-attention for prefill (full sequence), through kernel B2 on CUDA.

The reference's sharding ``Policy`` constraints are dropped: the port runs
one worker on one device. The staged-cache decode (``AttnCache``,
``attend_partial``/``merge_partials``) is not ported; the serving engine
decodes through the paged kernel instead."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import rope


def _qkv(x: torch.Tensor, p, arch):
    """Project x: (B, S, D) -> q (B, S, Hq, hd), k, v (B, S, Hkv, hd)."""
    b, s, _ = x.shape
    hd = arch.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if arch.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, arch.n_heads, hd),
            k.reshape(b, s, arch.n_kv_heads, hd),
            v.reshape(b, s, arch.n_kv_heads, hd))


def _apply_rope(arch, q, k, positions):
    if arch.pos_emb.value == "rope":
        q = rope(q, positions, arch.rope_theta)
        k = rope(k, positions, arch.rope_theta)
    return q, k


def self_attention_full(x: torch.Tensor, p, arch, *,
                        positions: Optional[torch.Tensor] = None,
                        return_kv: bool = False):
    """Causal full-sequence self-attention (prefill). x: (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _qkv(x, p, arch)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k = _apply_rope(arch, q, k, positions)
    out = flash_attention(q, k, v, causal=True)
    out = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out
