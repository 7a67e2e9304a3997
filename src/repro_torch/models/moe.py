"""Mixture-of-Experts FFN, the single-rank path of the reference's
``repro.models.moe``.

Each layer routes every token to its ``top_k`` experts (fp32 router,
softmax, top-k renormalised), sorts the assignments by expert, truncates
each expert to a static capacity (GShard semantics: overflow drops the
assignment), gathers the kept tokens into an (E, capacity, D) buffer, runs
the three expert products, and adds each token's weighted expert outputs
back. Every shape is static, as in the traced reference: no host sync per
layer.

Expert counts are padded to a multiple of the expert-parallel degree with
dummy experts whose router logits are -inf (``padded_experts``). The
expert-parallel path is not ported: ``ep > 1`` raises."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import _gelu_tanh, _silu, gated_mlp

NEG_INF = -1e30


def padded_experts(n_experts: int, ep: int) -> int:
    """Number of expert slots after padding to a multiple of the EP degree."""
    return ((n_experts + ep - 1) // ep) * ep


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, in descending order, ties to the
    lower index as ``jax.lax.top_k`` resolves them (``torch.topk``
    promises no order for ties; a stable sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_local(x_flat, router_w, w_gate, w_up, w_down, *, top_k: int,
               n_real: int, n_pad: int, e_lo: int, capacity: int, act: str):
    """Routed-expert compute for experts [e_lo, e_lo + E_loc) held locally.

    x_flat: (T, D); router_w: (D, n_real) fp32; w_*: (E_loc, D, F) /
    (E_loc, F, D). Returns (out: (T, D), aux: (2,) fp32 [load-balance
    loss, drops])."""
    t, d = x_flat.shape
    e_loc = w_gate.shape[0]
    dev = x_flat.device
    logits = x_flat.float() @ router_w                          # (T, n_real)
    if n_pad > n_real:
        logits = torch.cat([logits, logits.new_full((t, n_pad - n_real),
                                                    NEG_INF)], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, top_k)                         # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_w = top_w.reshape(-1)
    local = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    # sort so local assignments come first, grouped by expert
    sort_key = torch.where(local, flat_e - e_lo, e_loc)
    order = torch.sort(sort_key, stable=True).indices
    k_max = e_loc * capacity
    order = order[:k_max]
    se = sort_key[order]                                        # (<= k_max,)
    st = flat_t[order]
    # rank within expert = index - first index of this expert
    first = torch.searchsorted(se, torch.arange(e_loc + 1, device=dev))
    pos_in_e = torch.arange(se.shape[0], device=dev) \
        - first[se.clamp(0, e_loc)]
    valid = (se < e_loc) & (pos_in_e < capacity)
    slot = torch.where(valid, se * capacity + pos_in_e, k_max)  # OOB -> drop

    # dropped assignments all write the spare row k_max, cut off after
    disp = x_flat.new_zeros((k_max + 1, d))
    disp[slot] = torch.where(valid[:, None], x_flat[torch.where(valid, st, 0)],
                             0)
    disp = disp[:k_max].reshape(e_loc, capacity, d)

    actf = _silu if act == "silu" else _gelu_tanh
    h = actf(torch.bmm(disp, w_gate)) * torch.bmm(disp, w_up)
    eo = torch.bmm(h, w_down).reshape(k_max, d)

    # combine. The reference scatter-adds the kept assignments in sorted
    # (ascending expert) order, rounding to eo's dtype after each add; here
    # each token's top_k outputs are put in ascending expert order and
    # added one at a time, which is that order with no atomics. Assignments
    # back in their (T, k) places: dropped ones keep slot k_max (zeros).
    slot_tk = torch.full((t * top_k,), k_max, dtype=slot.dtype, device=dev)
    slot_tk[order] = slot
    kept = slot_tk < k_max
    eo_z = torch.cat([eo, eo.new_zeros((1, d))])               # row k_max: 0
    contrib = eo_z[slot_tk] * torch.where(kept, flat_w, 0.0)[:, None] \
        .to(eo.dtype)
    contrib = contrib.reshape(t, top_k, d)
    by_expert = torch.argsort(top_e, dim=-1)                    # (T, k)
    contrib = torch.gather(contrib, 1,
                           by_expert[..., None].expand(t, top_k, d))
    out = contrib[:, 0]
    for i in range(1, top_k):
        out = out + contrib[:, i]

    # aux: load-balance loss (Switch-style) over global router state + drops
    frac_tokens = torch.zeros((n_pad,), dtype=torch.float32, device=dev) \
        .index_add_(0, flat_e, probs.new_ones(flat_e.shape)) / (t * top_k)
    frac_probs = probs.mean(0)
    lb_loss = n_real * torch.sum(frac_tokens * frac_probs)
    drops = torch.clamp(local.sum() - valid.sum(), min=0).float()
    return out, torch.stack([lb_loss, drops])


def moe_ffn(x: torch.Tensor, p: dict, arch,
            capacity_factor: Optional[float] = None, ep: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux[2]). Capacity is
    static: max(int(B * S * top_k / n_experts * cf), 4).

    ``ep``, and ``_moe_local``'s ``n_pad`` and ``e_lo``, mirror the
    reference's surface for the expert-parallel path (ROADMAP A11); on one
    rank they are 1, n_experts and 0. That path is to take the place of
    this branch, not to stand beside it."""
    if ep > 1:
        raise NotImplementedError("expert parallelism (ep > 1) is not "
                                  "ported; the port runs one rank")
    moe = arch.moe
    b, s, d = x.shape
    cf = capacity_factor if capacity_factor is not None \
        else moe.capacity_factor
    n_pad = padded_experts(moe.n_experts, ep)
    if p["w_gate"].shape[0] != n_pad:
        raise ValueError(f"w_gate holds {p['w_gate'].shape[0]} experts, "
                         f"not {n_pad}")
    capacity = max(int(b * s * moe.top_k / moe.n_experts * cf), 4)
    out, aux = _moe_local(
        x.reshape(b * s, d), p["router"].float(), p["w_gate"], p["w_up"],
        p["w_down"], top_k=moe.top_k, n_real=moe.n_experts, n_pad=n_pad,
        e_lo=0, capacity=capacity, act=arch.act)
    return out.reshape(b, s, d).to(x.dtype), aux


def shared_expert_ffn(x, p, arch):
    """Always-on shared experts = one dense MLP of width d_shared."""
    return gated_mlp(x, p["sh_gate"], p["sh_up"], p["sh_down"], arch.act)
