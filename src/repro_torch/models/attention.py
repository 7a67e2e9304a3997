"""Self- and cross-attention for prefill (full sequence, through kernel B2
on CUDA) and the reference's staged-cache decode.

Decode keeps a large read-only segment ("big", filled by prefill and by
flushes) plus a small append buffer ("recent"); one token attends to both
as two partial flash states that are merged explicitly (``attend_partial``
/ ``merge_partials``, plain torch as the reference's are jnp).
``flush_cache`` moves recent -> big outside the hot step. The reference's
sharding ``Policy`` constraints are dropped: the port runs one worker on
one device. The paged serving engine decodes through kernel B1 instead.
Cross-attention (the VLM family) attends to frontend tokens: prefill
through B2 without a causal mask, decode against the K/V that prefill
computed from them, plain torch as the reference's is jnp."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (attend_partial,
                                                  merge_partials)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import rope

RECENT_WINDOW = 256     # decode append-buffer length between flushes


@dataclasses.dataclass
class AttnCache:
    """Staged decode cache for ONE attention site (or a stack of sites
    with leading dims; the sequence dim is always -3)."""
    k_big: torch.Tensor       # (B, S_max, Hkv, D)
    v_big: torch.Tensor
    k_recent: torch.Tensor    # (B, W, Hkv, D)
    v_recent: torch.Tensor
    big_len: int              # filled length of the big segment
    recent_len: int


def make_attn_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
                    dtype=torch.bfloat16, window: int = RECENT_WINDOW,
                    device=None) -> AttnCache:
    def z(s):
        return torch.zeros(s, dtype=dtype, device=device)
    return AttnCache(k_big=z((batch, s_max, n_kv, head_dim)),
                     v_big=z((batch, s_max, n_kv, head_dim)),
                     k_recent=z((batch, window, n_kv, head_dim)),
                     v_recent=z((batch, window, n_kv, head_dim)),
                     big_len=0, recent_len=0)


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


def cross_attention_full(x: torch.Tensor, kv_src: torch.Tensor, p, arch, *,
                         return_kv: bool = False):
    """Cross-attention of x (B, S, D), normed, to the frontend tokens
    ``kv_src`` (B, T, D), un-normed; no mask. k and v are projected in the
    type jnp promotes ``kv_src @ wk`` to (fp32 for an fp32 frontend into a
    bf16 layer), and q joins them there for B2, as the reference's logits
    are computed in fp32; the output comes back in q's type."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    hd = arch.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, arch.n_heads, hd)
    dt = torch.promote_types(kv_src.dtype, p["wk"].dtype)
    src = kv_src.to(dt)
    k = (src @ p["wk"].to(dt)).reshape(b, t, arch.n_kv_heads, hd)
    v = (src @ p["wv"].to(dt)).reshape(b, t, arch.n_kv_heads, hd)
    out = flash_attention(q.to(dt), k, v, causal=False).to(q.dtype)
    out = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def self_attention_decode(x: torch.Tensor, cache: AttnCache, p, arch
                          ) -> Tuple[torch.Tensor, AttnCache]:
    """One-token decode with the staged cache. x: (B, D) -> (B, D). The
    new token goes into the recent buffer at ``recent_len`` (a one-hot
    select, so the input cache is left as it was)."""
    b, _ = x.shape
    dev = x.device
    pos = cache.big_len + cache.recent_len
    q, k, v = _qkv(x[:, None, :], p, arch)
    q, k = _apply_rope(arch, q, k, torch.tensor([pos], device=dev))
    q = q[:, 0]                                         # (B, Hq, hd)
    k_new, v_new = k[:, 0], v[:, 0]                     # (B, Hkv, hd)

    w = cache.k_recent.shape[1]
    onehot = (torch.arange(w, device=dev) == cache.recent_len)[
        None, :, None, None]
    k_recent = torch.where(onehot, k_new[:, None], cache.k_recent)
    v_recent = torch.where(onehot, v_new[:, None], cache.v_recent)

    s_max = cache.k_big.shape[1]
    valid_big = (torch.arange(s_max, device=dev) < cache.big_len)[None] \
        .expand(b, s_max)
    part_big = attend_partial(q, cache.k_big, cache.v_big, valid_big)
    valid_rec = (torch.arange(w, device=dev) <= cache.recent_len)[None] \
        .expand(b, w)
    part_rec = attend_partial(q, k_recent, v_recent, valid_rec)
    out = merge_partials([part_big, part_rec]).to(x.dtype)

    out = out.reshape(b, -1) @ p["wo"]
    new_cache = dataclasses.replace(cache, k_recent=k_recent,
                                    v_recent=v_recent,
                                    recent_len=cache.recent_len + 1)
    return out, new_cache


def cross_attention_decode(x: torch.Tensor, cross_kv, p,
                           arch) -> torch.Tensor:
    """Decode-time cross-attention against the K/V that prefill computed
    from the frontend (``cross_kv``: (B, T, Hkv, hd) each). x: (B, D)."""
    b, _ = x.shape
    q = (x @ p["wq"]).reshape(b, arch.n_heads, arch.resolved_head_dim)
    k, v = cross_kv
    out = merge_partials([attend_partial(q, k, v, None)]).to(x.dtype)
    return out.reshape(b, -1) @ p["wo"]


def flush_cache(cache: AttnCache) -> AttnCache:
    """Move the recent buffer into the big segment (outside the hot decode
    step, once every window of tokens). Takes stacked (L, B, S, H, D)
    caches too; the sequence dim is always -3. The whole window is written
    from ``big_len`` on, with the start clamped so it fits, as the
    reference's ``dynamic_update_slice`` does."""
    s_max, w = cache.k_big.shape[-3], cache.k_recent.shape[-3]
    if w > s_max:
        raise ValueError(f"flush_cache: window {w} exceeds the big segment "
                         f"({s_max})")
    start = max(0, min(cache.big_len, s_max - w))

    def write(big, rec):
        big = big.clone()
        big[..., start:start + w, :, :] = rec.to(big.dtype)
        return big
    return dataclasses.replace(
        cache, k_big=write(cache.k_big, cache.k_recent),
        v_big=write(cache.v_big, cache.v_recent),
        big_len=cache.big_len + cache.recent_len, recent_len=0,
        k_recent=torch.zeros_like(cache.k_recent),
        v_recent=torch.zeros_like(cache.v_recent))
