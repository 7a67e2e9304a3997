"""Paged decode attention (kernel B1): the CUDA kernel's wrapper and its
plain PyTorch version, which mirrors the reference oracle
``repro.kernels.decode_attention.ref.paged_decode_ref`` (gather the pages,
then one masked softmax per GQA group in fp32), and the staged-cache
decode's plain building blocks ``attend_partial`` / ``merge_partials``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
in ``csrc/paged_decode.cu`` or raises. The kernel splits each sequence's
walk into runs of pages (``split_plan``) and merges the runs' partial
softmax states; ``paged_decode_split_ref`` repeats that partition and
merge in plain PyTorch, and no dispatch reaches it."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, refuse_dtensor

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GROUP = 8
_SPLIT_POSITIONS = 64     # a split's least run of positions
_MAX_SPLIT_PAGES = 64     # block-table entries the kernel holds a split
_MAX_SPLITS = 256         # splits the kernel merges a sequence
_MAX_CTAS = 2048          # above this the splits grow (15.5 an H100 SM)


def split_plan(b: int, hkv: int, max_pages: int, page: int):
    """(pages a split covers, splits a sequence) of kernel B1's grid
    (splits, Hkv, B). A split is ~64 positions (at least one page), so the
    live splits of a batch with 1-3 live sequences of hundreds of positions
    still put several CTAs on every SM; it doubles while the grid would
    exceed 2048 CTAs (up to 512 positions) or a sequence 256 splits. Split
    s covers positions [s * pages * page, (s + 1) * pages * page) of the
    block table's max_pages * page; the last split may be cut short."""
    pages = min(max(1, _SPLIT_POSITIONS // page), max_pages)

    def splits():
        return -(-max_pages // pages)
    while ((b * hkv * splits() > _MAX_CTAS and 2 * pages * page <= 512)
           or splits() > _MAX_SPLITS) \
            and 2 * pages <= min(max_pages, _MAX_SPLIT_PAGES):
        pages *= 2
    return pages, splits()


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial flash state over one KV segment (the staged-cache decode's
    building block; plain torch, as the reference's is jnp).

    q: (B, Hq, D); k, v: (B, S, Hkv, D); valid: (B, S) bool or None.
    Returns m, l: (B, Hq); o: (B, Hq, D) unnormalised (o = sum p*v)."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if valid is not None:
        logits = torch.where(valid[:, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                              # (B, Hkv, G)
    p = torch.exp(logits - m[..., None])
    l_run = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return m.reshape(b, hq), l_run.reshape(b, hq), o.reshape(b, hq, d)


def merge_partials(parts: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]]) -> torch.Tensor:
    """Associative merge of flash states; returns normalised (B, Hq, D)."""
    m, l_run, o = parts[0]
    for m2, l2, o2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        a1 = torch.exp(m - m_new)
        a2 = torch.exp(m2 - m_new)
        l_run = l_run * a1 + l2 * a2
        o = o * a1[..., None] + o2 * a2[..., None]
        m = m_new
    return o / torch.clamp_min(l_run, 1e-37)[..., None]


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (n_pages, page, Hkv, D); block_table:
    (B, max_pages) int; lengths: (B,) int -> (B, Hq, D) in q's type."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    max_pages = block_table.shape[1]
    s = max_pages * page
    bt = block_table.long()
    k = k_pages[bt].reshape(b, s, hkv, d)
    v = v_pages[bt].reshape(b, s, hkv, d)
    scale = scale if scale is not None else d ** -0.5
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l_run = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = o / torch.clamp_min(l_run, 1e-37)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Kernel B1's partition and merge in plain PyTorch (fp32): each split
    of ``split_plan`` gives a partial (m, l, o) over its live positions (a
    split at or past the sequence's length gives m = -inf, l = 0, o = 0),
    and ``merge_partials`` merges them in order, as the kernel's merge
    does; returns o / l in q's type. A length-0 row scores every position
    of its block-table row 0, so the merge gives the mean of V (C7).
    Shapes as ``paged_decode_ref``."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    max_pages = block_table.shape[1]
    pages, n_splits = split_plan(b, hkv, max_pages, page)
    cap, span = max_pages * page, pages * page
    g = hq // hkv
    bt = block_table.long()
    k = k_pages[bt].reshape(b, cap, hkv, d).float()
    v = v_pages[bt].reshape(b, cap, hkv, d).float()
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(b, hkv, g, d).float(), k) * scale
    lengths = lengths.to(q.device).long()
    uniform = lengths <= 0
    eff = torch.where(uniform, cap, lengths.clamp(max=cap))
    logits = torch.where(uniform[:, None, None, None],
                         torch.zeros_like(logits), logits)
    live_pos = torch.arange(cap, device=q.device)[None, :] < eff[:, None]
    logits = logits.masked_fill(~live_pos[:, None, None, :], -torch.inf)
    parts = []
    for s in range(n_splits):
        lo, hi = s * span, min((s + 1) * span, cap)
        seg = logits[..., lo:hi]                       # (B, Hkv, G, span)
        live = (lo < eff)[:, None, None]
        m = torch.where(live, seg.amax(dim=-1), -torch.inf)
        p = torch.exp(seg - torch.where(live, m, 0.0)[..., None])
        o = torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi])
        parts.append((m.reshape(b, hq), p.sum(dim=-1).reshape(b, hq),
                      o.reshape(b, hq, d)))
    return merge_partials(parts).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """See paged_decode_ref. On CUDA, block_table and lengths are int32,
    and an input that requires grad while grad mode is on is refused with
    a RuntimeError: the kernel has no backward. A DTensor is refused with
    a TypeError (``refuse_dtensor``)."""
    refuse_dtensor("paged_decode_attention", q, k_pages, v_pages,
                   block_table, lengths)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, block_table, lengths,
                                scale)
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention: unsupported device "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError(
            "paged_decode_attention: kernel B1 has no backward on CUDA "
            "(ROADMAP.md, queue B, 'Backward for B1'); decode runs under "
            "torch.no_grad()")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, hq, d = q.shape
    _, page, hkv, dk = k_pages.shape
    if dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} and "
                         f"pages {tuple(k_pages.shape)} do not form GQA "
                         "heads")
    if d not in (64, 128):
        raise ValueError(f"paged_decode_attention: head dim {d} not in "
                         "(64, 128)")
    if hq // hkv > _MAX_GROUP:
        raise ValueError(f"paged_decode_attention: {hq // hkv} query heads "
                         f"per kv head; the kernel takes up to {_MAX_GROUP}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: dtypes {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}; one of {_DTYPES} "
                        "expected")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_table.dim() != 2 or block_table.shape[0] != b \
            or block_table.shape[1] == 0 \
            or lengths.shape != (b,):
        raise ValueError("paged_decode_attention: block_table (B, max_pages) "
                         "and lengths (B,) must be int32")
    if not all(t.device == q.device and t.is_contiguous()
               for t in (q, k_pages, v_pages, block_table, lengths)):
        raise ValueError("paged_decode_attention: inputs must be contiguous "
                         "on one device")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode_attention: q and the pools must be "
                         "16-byte aligned (vector loads of whole rows)")
    max_pages = block_table.shape[1]
    pages, n_splits = split_plan(b, hkv, max_pages, page)
    if n_splits > _MAX_SPLITS:
        raise ValueError(f"paged_decode_attention: {max_pages} pages of "
                         f"{page} a sequence need {n_splits} splits; the "
                         f"kernel merges up to {_MAX_SPLITS}")
    out = torch.empty_like(q)
    # the splits' partials: o (B, Hq, splits, D), then (m, l)
    part = torch.empty((b * hq * n_splits * (d + 2),), dtype=torch.float32,
                       device=q.device)
    _build.module().paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), part.data_ptr(), b, hq,
        hkv, d, page, max_pages, pages,
        float(scale if scale is not None else d ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

__all__ = ["paged_decode_attention", "paged_decode_ref",
           "paged_decode_split_ref", "split_plan", "attend_partial",
           "merge_partials"]
