"""Self- and cross-attention for prefill (full sequence, through kernel B2
on CUDA) and the reference's staged-cache decode.

Decode keeps a large read-only segment ("big", filled by prefill and by
flushes) plus a small append buffer ("recent"); one token attends to both
as two partial flash states that are merged explicitly (``attend_partial``
/ ``merge_partials``, plain torch as the reference's are jnp).
``flush_cache`` moves recent -> big outside the hot step. The paged
serving engine decodes through kernel B1 instead. Cross-attention (the VLM
family) attends to frontend tokens: prefill through B2 without a causal
mask, decode against the K/V that prefill computed from them, plain torch
as the reference's is jnp.

Distribution comes from the ``Policy``'s constraints at the reference's
sites (``DTensor.redistribute`` under a mesh, nothing without one). B2
runs on each rank's heads through ``local_map`` (``_flash``). Query heads
that their mesh axes do not divide (24 or 40 over 16) are padded with
zero heads to a multiple of the axes, as GSPMD pads them, so that each
rank takes ceil(H / axes) of them and B2 runs on its real ones; the
output projection drops the padded heads (``_project_out``). K/V heads
that the policy leaves whole while the query heads are sharded (GQA heads
that do not divide the axes) are picked on each rank for its own query
heads. Decode attends over a sequence-sharded cache as flash-decoding
does (``_attend``): each rank its own positions, the partial states
combined by all-reduces (a few values a head, never the cache)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import NO_POLICY, Policy
from repro_torch.kernels.decode_attention import (attend_partial,
                                                  merge_partials)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import rope

_Q = ("batch", "seq_q", "heads", None)
_KV = ("batch", None, "kv_heads", None)

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


def _qkv(x: torch.Tensor, p, arch, policy: Policy):
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
    q = policy.constrain(_split_heads(q, b, s, arch.n_heads, hd), _Q)
    # K/V are never sequence-sharded here: one gather a layer, heads-
    # sharded where the KV heads divide the axis
    k = policy.constrain(_split_heads(k, b, s, arch.n_kv_heads, hd), _KV)
    v = policy.constrain(_split_heads(v, b, s, arch.n_kv_heads, hd), _KV)
    return q, k, v


def _split_heads(t, b: int, s: int, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd). A DTensor sharded on its last dim
    over a mesh dim that does not divide ``n`` (whole heads) is gathered
    on that mesh dim first, as GSPMD gathers it."""
    if isinstance(t, DTensor):
        mesh, d = t.device_mesh, t.ndim - 1
        pl = [Replicate() if p.is_shard(d) and n % mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(b, s, n, hd)


def _apply_rope(arch, q, k, positions):
    if arch.pos_emb.value == "rope":
        q = rope(q, positions, arch.rope_theta)
        k = rope(k, positions, arch.rope_theta)
    return q, k


def _heads_here(t):
    """(first, count): this rank's heads (dim 2) of a DTensor whose heads
    its mesh dims divide, split in mesh order as ``Shard`` splits them."""
    first, n = 0, t.shape[2]
    coord = t.device_mesh.get_coordinate()
    for i, pl in enumerate(t.placements):
        if pl == Shard(2):
            n //= t.device_mesh.size(i)
            first += coord[i] * n
    return first, n


def _flash(q, k, v, policy: Policy, *, causal: bool):
    """B2 on each rank's local heads (``local_map``): q (B, S, Hq, hd) laid
    out as ``_Q``, k and v as ``_KV``. Returns (B, S, Hp, hd), Hp being Hq
    padded to a multiple of the heads' mesh axes (see the module
    docstring); the padded heads are zeros."""
    if policy.mesh is None:
        return flash_attention(q, k, v, causal=causal)
    if policy.spec(_Q)[1] is not None:
        raise NotImplementedError("sequence-sharded attention (attn_mode "
                                  "'seq') is not ported")
    h, hkv = q.shape[2], k.shape[2]
    hp = -(-h // policy.axis_size("heads")) * policy.axis_size("heads")
    if hp != h:
        q = policy.local(lambda q_: F.pad(q_, (0, 0, 0, hp - h)), (_Q,),
                         _Q)(q)
        q = policy.constrain(q, _Q)
    pick = policy.spec(_KV)[2] != policy.spec(_Q)[2]
    off = _heads_here(q)[0]

    def local(q_, k_, v_):
        n = max(0, min(q_.shape[2], h - off))        # real heads here
        if n == 0:
            return torch.zeros_like(q_)
        if pick:
            # K/V whole over the heads' axes: each query head's own
            idx = torch.arange(off, off + n, device=q_.device) // (h // hkv)
            k_, v_ = k_.index_select(2, idx), v_.index_select(2, idx)
        if n == q_.shape[2]:
            return flash_attention(q_, k_, v_, causal=causal)
        out = flash_attention(q_[:, :, :n].contiguous(), k_, v_,
                              causal=causal)
        return F.pad(out, (0, 0, 0, q_.shape[2] - n))
    kv_axes = ("batch", None, None, None) if pick else _KV
    return policy.local(local, (_Q, kv_axes, kv_axes), _Q)(q, k, v)


def _project_out(out, wo, n_heads: int):
    """The attention output (B, S, Hp, hd) through ``wo`` -> (B, S, D).
    Padded query heads (Hp > n_heads, ``_flash``) are dropped: each rank
    projects its real heads through their rows of ``wo`` (gathered), and
    the partial sums are added where the result is next laid out, as the
    row-parallel product of unpadded heads is."""
    b, s, hp, hd = out.shape
    if hp == n_heads:
        return out.reshape(b, s, -1) @ wo
    mesh, opl = out.device_mesh, tuple(out.placements)
    off, n = _heads_here(out)
    lo, hi = min(off, n_heads), min(off + n, n_heads)

    def local(o_, w_):
        return o_[:, :, :hi - lo].flatten(2) @ w_[lo * hd:hi * hd]
    return local_map(
        local, out_placements=[Partial() if pl == Shard(2) else pl
                               for pl in opl],
        in_placements=(opl, [Replicate()] * mesh.ndim), device_mesh=mesh,
        redistribute_inputs=True)(out, wo)


def self_attention_full(x: torch.Tensor, p, arch,
                        policy: Policy = NO_POLICY, *,
                        positions: Optional[torch.Tensor] = None,
                        return_kv: bool = False):
    """Causal full-sequence self-attention (prefill). x: (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _qkv(x, p, arch, policy)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k = _apply_rope(arch, q, k, positions)
    out = _flash(q, k, v, policy, causal=True)
    out = _project_out(policy.constrain(out, _Q), p["wo"], arch.n_heads)
    if return_kv:
        # storage layout: the serve cache is sequence-sharded
        k = policy.constrain(k, ("batch", "kv_seq", None, None))
        v = policy.constrain(v, ("batch", "kv_seq", None, None))
        return out, (k, v)
    return out


def cross_attention_full(x: torch.Tensor, kv_src: torch.Tensor, p, arch,
                         policy: Policy = NO_POLICY, *,
                         return_kv: bool = False):
    """Cross-attention of x (B, S, D), normed, to the frontend tokens
    ``kv_src`` (B, T, D), un-normed; no mask. k and v are projected in the
    type jnp promotes ``kv_src @ wk`` to (fp32 for an fp32 frontend into a
    bf16 layer), and q joins them there for B2, as the reference's logits
    are computed in fp32; the output comes back in q's type. K/V are laid
    out along the frontend sequence, as the cache keeps them; B2 gathers
    the sequence of its heads."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    hd = arch.resolved_head_dim
    q = _split_heads(x @ p["wq"], b, s, arch.n_heads, hd)
    dt = torch.promote_types(kv_src.dtype, p["wk"].dtype)
    src = kv_src.to(dt)
    k = _split_heads(src @ p["wk"].to(dt), b, t, arch.n_kv_heads, hd)
    v = _split_heads(src @ p["wv"].to(dt), b, t, arch.n_kv_heads, hd)
    q = policy.constrain(q, _Q)
    k = policy.constrain(k, ("batch", "frontend_seq", "kv_heads", None))
    v = policy.constrain(v, ("batch", "frontend_seq", "kv_heads", None))
    out = _flash(q.to(dt), k, v, policy, causal=False).to(q.dtype)
    out = _project_out(out, p["wo"], arch.n_heads)
    if return_kv:
        return out, (k, v)
    return out


def _attend(q, k, v, valid, policy: Policy):
    """``attend_partial`` of q (B, Hq, hd) over k, v (B, S, Hkv, hd) and
    ``valid`` (B, S) bool or None, as they are laid out: each rank's
    partial state over its own positions, then the states combined across
    the sequence shards by two all-reduces (the max, then the rescaled
    sums), as flash-decoding's combine. The K/V are never gathered; q is
    (every rank takes all its heads)."""
    if policy.mesh is None or not isinstance(k, DTensor):
        return attend_partial(q, k, v, valid)
    mesh, kpl = k.device_mesh, tuple(k.placements)
    if any(pl.is_shard() and pl.dim > 1 for pl in kpl):
        raise ValueError(f"_attend: K/V laid out {kpl}: heads must be "
                         "whole on a rank")
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in kpl)

    def over_seq(op):
        return [Partial(op) if pl == Shard(1) else r
                for pl, r in zip(kpl, rows)]
    if valid is None:
        valid = torch.ones(k.shape[:2], dtype=torch.bool, device=q.device)
    if not isinstance(valid, DTensor):
        valid = distribute_tensor(valid, mesh, kpl, src_data_rank=None)
    m, l_run, o = local_map(
        attend_partial, out_placements=(over_seq("max"),
                                        over_seq("sum"), over_seq("sum")),
        in_placements=(rows, kpl, kpl, kpl), device_mesh=mesh,
        redistribute_inputs=True)(q, k, v, valid)
    mx = m.redistribute(mesh, rows)

    def rescaled(m_, mx_, l_, o_):
        a = torch.exp(m_ - mx_)
        return l_ * a, o_ * a[..., None]
    l_run, o = local_map(
        rescaled, out_placements=(over_seq("sum"),) * 2,
        in_placements=(over_seq("max"), rows, over_seq("sum"),
                       over_seq("sum")), device_mesh=mesh)(m, mx, l_run, o)
    return mx, l_run.redistribute(mesh, rows), o.redistribute(mesh, rows)


def self_attention_decode(x: torch.Tensor, cache: AttnCache, p, arch,
                          policy: Policy = NO_POLICY
                          ) -> Tuple[torch.Tensor, AttnCache]:
    """One-token decode with the staged cache. x: (B, D) -> (B, D). The
    new token goes into the recent buffer at ``recent_len`` (a one-hot
    select, so the input cache is left as it was)."""
    b, _ = x.shape
    dev = x.device
    pos = cache.big_len + cache.recent_len
    q, k, v = _qkv(x[:, None, :], p, arch, policy)
    q, k = _apply_rope(arch, q, k, torch.tensor([pos], device=dev))
    q = q[:, 0]                                         # (B, Hq, hd)
    k_new, v_new = k[:, 0], v[:, 0]                     # (B, Hkv, hd)

    # the recent buffer is small and replicated
    w = cache.k_recent.shape[1]
    onehot = (torch.arange(w, device=dev) == cache.recent_len)[
        None, :, None, None]
    rec = ("batch", None, None, None)
    k_recent = policy.constrain(
        torch.where(onehot, k_new[:, None], cache.k_recent), rec)
    v_recent = policy.constrain(
        torch.where(onehot, v_new[:, None], cache.v_recent), rec)

    # two partial flash states: big (sequence-sharded) + recent
    s_max = cache.k_big.shape[1]
    valid_big = (torch.arange(s_max, device=dev) < cache.big_len)[None] \
        .expand(b, s_max)
    part_big = _attend(q, cache.k_big, cache.v_big, valid_big, policy)
    valid_rec = (torch.arange(w, device=dev) <= cache.recent_len)[None] \
        .expand(b, w)
    part_rec = _attend(q, k_recent, v_recent, valid_rec, policy)
    out = merge_partials([part_big, part_rec]).to(x.dtype)

    out = policy.constrain(out, ("batch", "heads", None))
    out = out.reshape(b, -1) @ p["wo"]
    new_cache = dataclasses.replace(cache, k_recent=k_recent,
                                    v_recent=v_recent,
                                    recent_len=cache.recent_len + 1)
    return out, new_cache


def cross_attention_decode(x: torch.Tensor, cross_kv, p, arch,
                           policy: Policy = NO_POLICY) -> torch.Tensor:
    """Decode-time cross-attention against the K/V that prefill computed
    from the frontend (``cross_kv``: (B, T, Hkv, hd) each). x: (B, D)."""
    b, _ = x.shape
    q = _split_heads(x[:, None] @ p["wq"], b, 1, arch.n_heads,
                     arch.resolved_head_dim)[:, 0]
    k, v = cross_kv
    out = merge_partials([_attend(q, k, v, None, policy)]).to(x.dtype)
    return out.reshape(b, -1) @ p["wo"]


def _write_window(big: torch.Tensor, rec: torch.Tensor,
                  start: int) -> torch.Tensor:
    """A copy of ``big`` with ``rec`` written along the sequence dim (-3)
    from ``start``; on a sequence-sharded DTensor each rank writes the
    part that falls in its own positions."""
    w = rec.shape[-3]
    if not isinstance(big, DTensor):
        big = big.clone()
        big[..., start:start + w, :, :] = rec.to(big.dtype)
        return big
    # private to DTensor: imported here, where a sharded flush needs it
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        big.shape, big.device_mesh, big.placements)
    lo, n = offset[-3], shape[-3]
    a, z = max(start, lo), min(start + w, lo + n)

    def local(b_, r_):
        b_ = b_.clone()
        if a < z:
            b_[..., a - lo:z - lo, :, :] = \
                r_[..., a - start:z - start, :, :].to(b_.dtype)
        return b_
    rpl = tuple(Replicate() if pl == Shard(big.ndim - 3) else pl
                for pl in big.placements)
    return local_map(local, out_placements=list(big.placements),
                     in_placements=(tuple(big.placements), rpl),
                     device_mesh=big.device_mesh,
                     redistribute_inputs=True)(big, rec)


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
    return dataclasses.replace(
        cache, k_big=_write_window(cache.k_big, cache.k_recent, start),
        v_big=_write_window(cache.v_big, cache.v_recent, start),
        big_len=cache.big_len + cache.recent_len, recent_len=0,
        k_recent=torch.zeros_like(cache.k_recent),
        v_recent=torch.zeros_like(cache.v_recent))
