"""GQA flash attention (kernel B2): the CUDA kernel's wrapper and its plain
PyTorch versions.

``flash_attention_ref`` mirrors the reference's memory-bounded chunked
oracle (``repro.kernels.flash_attention.ref``): KV chunks of ``kv_chunk``
with an fp32 running softmax, and ``p`` cast to ``v``'s type before
``p @ v``, so bf16 rounding matches the JAX prefill path. A CPU tensor goes
to it; a CUDA tensor goes to the kernel in ``csrc/flash_attention.cu`` or
raises. On the card the bf16 kernel's q tile and launch order
(``launch_plan``) and the fp32 kernel's key splits (``f32_kv_splits``,
``f32_tiles``) are chosen here, where the CPU tests can reach them.

Under autograd the forward kernel also writes each row's logsumexp, and the
backward is a kernel too (``csrc/flash_attention_bwd.cu``,
``flash_attention_backward``); its plain version is the closed form
``flash_attention_bwd``, and the tiles it visits are listed by
``bwd_tiles``.

The fp32 kernel takes each product on the tensor cores as three tf32
products of split operands; ``flash_attention_split`` repeats those
numerics in plain PyTorch, for the tests. ``flash_attention.launches``
counts every launch, ``flash_attention.launches_fp32`` and
``launches_bf16`` each route's."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_dtensor

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
N_SMS = 132                          # H100 SXM


def launch_plan(b: int, sq: int, hq: int):
    """The bf16 kernel's q tile and tile count for q (b, sq, hq, D): 128
    rows (two consumer warpgroups a CTA, one CTA an SM) while that still
    gives a tile for every SM, else 64 rows (one warpgroup, two CTAs an
    SM), which doubles the tiles. The kernel's CTAs, one for each resident
    slot of the card, walk the tiles in ``tile_rows`` order."""
    for block_q in (128, 64):
        n_tiles = hq * -(-sq // block_q) * b
        if block_q == 64 or n_tiles >= N_SMS:
            return block_q, n_tiles


def tile_rows(b: int, sq: int, hq: int):
    """(batch, head, first q row, rows) of each tile in the kernel's order
    (its ``tile_at``): every (head, batch) at the last q tile, then at the
    one before it, and so on, so under causal masking the heaviest tiles
    come first. The kernel deals them to its CTAs a round at a time, in
    snake order."""
    block_q, n_tiles = launch_plan(b, sq, hq)
    n_qt = -(-sq // block_q)
    out = []
    for tile in range(n_tiles):
        hb = tile % (hq * b)
        q0 = (n_qt - 1 - tile // (hq * b)) * block_q
        out.append((hb // hq, hb % hq, q0, min(block_q, sq - q0)))
    return out


def f32_kv_splits(b: int, sq: int, skv: int, hq: int) -> int:
    """The fp32 kernel's key splits for q (b, sq, hq, D) against skv keys:
    1 when its 64-row q tiles fill the card; else as many as keep every SM
    busy (``N_SMS`` // tiles), at most one for every 64 keys, so that each
    split's two key groups get a 32-key tile each."""
    tiles = -(-sq // 64) * hq * b
    return max(1, min(N_SMS // tiles, -(-skv // 64))) if tiles else 1


def f32_tiles(b: int, sq: int, skv: int, hq: int, *, causal: bool = True,
              q_offset: int = 0, kv_len=None):
    """The fp32 kernel's CTAs in launch order: (batch, head, first q row,
    key split, group 0's K/V tiles, group 1's), each tile as (first key,
    keys). A CTA takes a 64-row q tile, heaviest first, and split s of
    ``f32_kv_splits`` takes the s-th run of the 32-key tiles that the q
    tile can see (past kv_len and, if causal, its last row's position none
    is loaded); its two key groups take them in turns. A sequence that
    sees no key (``kv_len[b] == 0``) loads none."""
    splits = f32_kv_splits(b, sq, skv, hq)
    n_qt = -(-sq // 64)
    out = []
    for cta in range(n_qt * hq * b * splits):
        split, tile = cta % splits, cta // splits
        hb = tile % (hq * b)
        h, bb = hb % hq, hb // hq
        q0 = (n_qt - 1 - tile // (hq * b)) * 64
        groups = ([], [])
        kv_lim = skv if kv_len is None else min(skv, int(kv_len[bb]))
        if kv_lim > 0:
            kv_hi = min(kv_lim, q_offset + min(q0 + 64, sq)) if causal \
                else kv_lim
            n_tiles = -(-kv_hi // 32)
            per = -(-n_tiles // splits)
            lo = split * per
            for t in range(lo, min(n_tiles, lo + per)):
                groups[(t - lo) % 2].append((32 * t, min(32, kv_hi - 32 * t)))
        out.append((bb, h, q0, split, *groups))
    return out


def bwd_tiles(b: int, sq: int, skv: int, hq: int, hkv: int, *,
              causal: bool = True, q_offset: int = 0, kv_len=None,
              bf16: bool = True):
    """The backward kernel's visits: for each CTA in launch order, (batch,
    KV head, first key, keys) and the (query head, first q row, rows) tiles
    it walks, in its order. A CTA holds 128 keys in bf16 (64 in fp32) and
    walks 64-row query tiles of every query head of its group, head by
    head, from the first tile that can see its first key under causal
    masking (the tiles wholly above the diagonal are skipped). CTAs go key
    tile by key tile, the first first: under causal masking the longest
    (key tile 0 is seen from every query tile), so no CTA has more visits
    than one launched before it when no ``kv_len`` cuts the keys. A CTA of
    a sequence that sees no key (``kv_len[b] == 0``) or whose keys all lie
    at or past ``kv_len[b]`` visits nothing.

    In bf16 the CTA's two consumer warpgroups take 64 of its keys each
    (their dK and dV; the second fewer or none where Skv ends inside the
    CTA) and both walk all its visits. A visit's dQ is taken during the
    next visit, once both halves of its dS are in: for D = 112 or 128 each
    warpgroup takes one 64-column panel of it over all 128 keys, for D =
    64 all of it over its own 64 keys (both parts are added to the
    accumulator)."""
    bk, bq = (128 if bf16 else 64), 64
    g = hq // hkv
    n_qt = -(-sq // bq)
    out = []
    for cta in range(-(-skv // bk) * hkv * b):
        kt, rest = divmod(cta, hkv * b)
        hk, bb = rest % hkv, rest // hkv
        k0 = kt * bk
        kv_lim = skv if kv_len is None else min(skv, int(kv_len[bb]))
        visits = []
        if k0 < kv_lim:
            lo = (k0 - q_offset) // bq if causal and k0 > q_offset else 0
            visits = [(hk * g + hh, qt * bq, min(bq, sq - qt * bq))
                      for hh in range(g) for qt in range(lo, n_qt)]
        out.append((bb, hk, k0, min(bk, skv - k0), visits))
    return out


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def attention_dense_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """O(Sq*Skv)-memory reference. q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv,
    D); q_offset: global position of q[0]; kv_len: optional (B,) lengths.
    With ``return_lse`` also each row's logsumexp (see
    ``flash_attention_ref``)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask &= (qpos >= kpos)[None, None]
    if kv_len is not None:
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask &= (kpos < kv_len.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1)
    return out, torch.where(mask.any(-1), lse, float("inf"))


def _flash_chunked(q, k, v, q_offset, kv_len, scale, causal, kv_chunk,
                   return_lse=False):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    dev = q.device
    qpos = torch.arange(sq, device=dev)[:, None] + q_offset
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    qf = q.float()
    for k0 in range(0, skv, kv_chunk):
        kc = _repeat_kv(k[:, k0:k0 + kv_chunk], n_rep)
        vc = _repeat_kv(v[:, k0:k0 + kv_chunk], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
        kpos = k0 + torch.arange(kv_chunk, device=dev)[None, :]
        mask = torch.ones((b, 1, sq, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= (qpos >= kpos)[None, None]
        if kv_len is not None:
            mask &= (kpos[None] < kv_len.to(dev)[:, None, None])[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l_run, 1e-37)[..., None]
    out = out.transpose(1, 2).to(q.dtype)       # (B, Sq, Hq, D)
    if not return_lse:
        return out
    # a row that saw a key has a max above the masked logits' NEG_INF
    return out, torch.where(m > NEG_INF, m + torch.log(l_run), float("inf"))


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        kv_chunk: int = 256, return_lse: bool = False):
    """Memory-bounded flash attention (chunked over KV). Falls back to the
    dense form when Skv is not a multiple of the chunk, as the reference
    does.

    With ``return_lse``, (out, lse): lse (B, Hq, Sq) fp32 is each row's
    logsumexp of its scaled scores over the keys it sees, +inf for a row
    that sees none, as the kernel's forward writes it for the backward:
    exp(scale q k^T - lse) @ v is then the output of every row that sees a
    key."""
    skv = k.shape[1]
    kv_chunk = min(kv_chunk, skv)
    if skv % kv_chunk:
        return attention_dense_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, scale=scale,
                                   return_lse=return_lse)
    d = q.shape[-1]
    return _flash_chunked(q, k, v, int(q_offset), kv_len,
                          scale if scale is not None else d ** -0.5,
                          causal, kv_chunk, return_lse)


def _tf32(x: torch.Tensor, rna: bool = True) -> torch.Tensor:
    """fp32 ``x`` cut to tf32's 19 bits: rounded to nearest with ties away
    from zero (``rna``, the kernel's hi part) or truncated, as the tensor
    cores read an operand register (its lo part)."""
    bits = x.contiguous().view(torch.int32)
    if rna:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum(eq, a, b) of fp32 operands as B2's fp32 kernel takes it on
    the tensor cores: each operand split into hi = tf32(x) (nearest) and lo
    = x - hi, read truncated to tf32, and hi.hi + (hi.lo + lo.hi) summed in
    fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, rna=False), _tf32(b - bh, rna=False)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl)
                                       + torch.einsum(eq, al, bh))


def flash_attention_split(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          kv_len: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """The fp32 kernel's numerics in plain PyTorch, for the tests: S = q
    k^T and the unnormalised P V as ``split_einsum`` products, the masked
    softmax in fp32 (exp against the row max), O = (P V) / l. A row that
    sees no key gets the mean of V (C7) and, with ``return_lse``, a
    logsumexp of +inf; otherwise as ``attention_dense_ref``. fp32 inputs
    only."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k, v = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    s = split_einsum("bqhd,bkhd->bhqk", q, k) * scale
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask &= (qpos >= kpos[None, :])[None, None]
    if kv_len is not None:
        mask &= (kpos[None, :] < kv_len.to(q.device)[:, None]
                 )[:, None, None, :]
    s = torch.where(mask, s, -torch.inf)
    seen = mask.any(-1, keepdim=True)
    m = torch.where(seen, s.amax(-1, keepdim=True), 0.0)
    p = torch.exp(s - m)
    l_sum = p.sum(-1, keepdim=True)
    out = split_einsum("bhqk,bkhd->bhqd", p, v) / torch.where(seen, l_sum, 1)
    mean_v = v.mean(dim=1)[:, :, None, :]                    # (B, Hq, 1, D)
    out = torch.where(seen, out, mean_v).transpose(1, 2).contiguous()
    if not return_lse:
        return out
    lse = torch.where(seen, m + torch.log(l_sum), torch.inf)[..., 0]
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    kv_chunk: int = 256) -> torch.Tensor:
    """Causal (or not) GQA attention. q: (B, Sq, Hq, D); k, v: (B, Skv,
    Hkv, D) -> (B, Sq, Hq, D). ``kv_chunk`` shapes only the plain version.

    On CUDA, when grad mode is on and q, k or v requires grad, the kernel
    runs inside ``_FlashAttention``, whose backward is the backward kernel
    (``flash_attention_backward``); otherwise it launches bare. A DTensor
    is refused with a TypeError (``refuse_dtensor``)."""
    refuse_dtensor("flash_attention", q, k, v, kv_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, scale=scale,
                                   kv_chunk=kv_chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_len, causal, int(q_offset),
                                     scale)
    return _launch(q, k, v, causal, q_offset, kv_len, scale)


def _check(q, k, v, kv_len, q_offset, name="flash_attention"):
    """Raise for what the kernels do not take; return (b, sq, skv, hq, hkv,
    d, bf16)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not form GQA heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; one of {_DTYPES} expected")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and skv == 0:
        raise ValueError(f"{name}: bf16 needs Skv >= 1 (its TMA "
                         "tensor maps have no empty dimension)")
    if d not in (64, 128) and not (d == 112 and q.dtype == torch.bfloat16):
        raise ValueError(f"{name}: head dim {d} not in (64, 128), "
                         "or 112 in bf16")
    if not all(t.device == q.device and t.is_contiguous()
               for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous on "
                         "one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be 16-byte aligned "
                         "(TMA and whole-row vector loads)")
    if kv_len is not None and (kv_len.dtype != torch.int32
                               or kv_len.shape != (b,)
                               or kv_len.device != q.device
                               or not kv_len.is_contiguous()):
        raise ValueError(f"{name}: kv_len must be a contiguous "
                         "(B,) int32 tensor on q's device")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    return b, sq, skv, hq, hkv, d, bf16


def _launch(q, k, v, causal, q_offset, kv_len, scale,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check the inputs, launch the CUDA kernel and count the launch; with
    ``lse`` ((B, Hq, Sq) fp32) the kernel also writes each row's
    logsumexp there."""
    b, sq, skv, hq, hkv, d, bf16 = _check(q, k, v, kv_len, q_offset)
    out = torch.empty_like(q)
    block_q = launch_plan(b, sq, hq)[0] if bf16 else 64
    splits = 1 if bf16 else f32_kv_splits(b, sq, skv, hq)
    # the key splits' normalised rows and logsumexps, merged by the kernel
    part = None if splits == 1 else torch.empty(
        splits * b * hq * sq * (d + 1), dtype=torch.float32, device=q.device)
    # torch._C._cuda_getCurrentRawStream (private; PyTorch's generated
    # Triton launchers read the stream through it) gives the handle as an
    # int without building a torch.cuda.Stream
    _build.module().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        None if part is None else part.data_ptr(),
        b, sq, skv, hq, hkv, d, int(q_offset), int(causal),
        float(scale if scale is not None else d ** -0.5), block_q, splits,
        int(bf16), torch._C._cuda_getCurrentRawStream(q.get_device()))
    flash_attention.launches += 1
    if bf16:
        flash_attention.launches_bf16 += 1
    else:
        flash_attention.launches_fp32 += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """B2 under autograd: the kernel's forward, which also writes each
    row's logsumexp, and the backward kernel (``flash_attention_backward``)
    reading it. The reference has no backward kernel: its gradient is XLA's
    autodiff of the jnp attention, outside Pallas. ``kv_len`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, q_offset, scale):
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, causal, q_offset, kv_len, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.args = (causal, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        causal, q_offset, scale = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, causal=causal,
            q_offset=q_offset, kv_len=kv_len, scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool = True,
                             q_offset: int = 0,
                             kv_len: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None):
    """(dq, dk, dv) from the backward kernel (``csrc/flash_attention_bwd.cu``)
    on CUDA tensors: the forward's q, k, v, out and its logsumexp ``lse``
    ((B, Hq, Sq) fp32), and ``dout`` like out. Counts its launch in
    ``flash_attention_backward.launches``. Its plain version is
    ``flash_attention_bwd`` (give it ``lse``); a shape the kernel does not
    take raises, and nothing falls back."""
    refuse_dtensor("flash_attention_backward", q, k, v, out, dout, lse,
                   kv_len)
    b, sq, skv, hq, hkv, d, bf16 = _check(q, k, v, kv_len, q_offset,
                                          "flash_attention_backward")
    if skv == 0:
        raise ValueError("flash_attention_backward: Skv must be >= 1")
    if not all(t.shape == q.shape and t.dtype == q.dtype
               and t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in (out, dout)):
        raise ValueError("flash_attention_backward: out and dout must be "
                         "contiguous, 16-byte aligned and like q")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be a "
                         "contiguous (B, Hq, Sq) fp32 tensor on q's device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
        if bf16 else dq
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.module().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(), delta.data_ptr(),
        b, sq, skv, hq, hkv, d, int(q_offset), int(causal),
        float(scale if scale is not None else d ** -0.5), int(bf16),
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    flash_attention_backward.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        q_offset: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        lse: Optional[torch.Tensor] = None,
                        block_elems: int = 1 << 26):
    """Gradients (dq, dk, dv) of attention with output ``out`` and output
    gradient ``dout``, in closed form, in fp32, returned in the inputs'
    types: the gradient the reference's autodiff takes of its masked
    softmax attention; the plain version of the backward kernel. With
    ``lse`` (the forward's (B, Hq, Sq) logsumexp, ``flash_attention_ref(...,
    return_lse=True)``) it is read and not recomputed.

    Query rows go in chunks whose fp32 score block (B, Hq, rows, keys)
    holds at most ``block_elems`` values; under causal masking a chunk
    reads only the keys its last row can see. For each chunk: the scores
    S = q k^T * scale with masked logits at NEG_INF, each row's logsumexp
    (given, or recomputed), P = exp(S - lse) (zero where masked), delta =
    rowsum(dout * out), dV += P^T dO, dS = P * (dO V^T - delta), dQ = dS K
    * scale, dK += dS^T Q * scale, with dK and dV summed over each GQA
    group. A row that sees no key gets the mean of V over all Skv keys in
    the forward (the uniform softmax of all-NEG_INF logits): its dQ is 0,
    it gives no dK, and it adds dO / Skv to every key's dV."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q_offset = int(q_offset)
    dev = q.device
    f32 = torch.float32
    dq = torch.zeros((b, sq, hkv, g, d), dtype=f32, device=dev)
    dk = torch.zeros((b, skv, hkv, d), dtype=f32, device=dev)
    dv = torch.zeros((b, skv, hkv, d), dtype=f32, device=dev)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=dev)
    rows = max(1, min(sq, block_elems // max(1, b * hq * skv)))
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        n = r1 - r0
        kend = min(skv, max(0, r1 + q_offset)) if causal else skv
        if kend == 0:
            continue
        qc, oc, doc = (t[:, r0:r1].float().reshape(b, n, hkv, g, d)
                       for t in (q, out, dout))
        kc, vc = kf[:, :kend], vf[:, :kend]
        mask = torch.ones((1, 1, 1, n, kend), dtype=torch.bool, device=dev)
        if causal:
            qpos = torch.arange(r0, r1, device=dev) + q_offset
            mask = mask & (qpos[:, None] >= kpos[None, :kend])
        if kv_len is not None:
            mask = mask & (kpos[:kend] < kv_len.to(dev)[:, None]
                           )[:, None, None, None, :]
        s = torch.einsum("bnhgd,bkhd->bhgnk", qc, kc) * scale
        s = torch.where(mask, s, NEG_INF)
        if lse is None:
            rows_lse = torch.logsumexp(s, dim=-1, keepdim=True)
        else:
            rows_lse = lse[:, :, r0:r1].float().reshape(
                b, hkv, g, n)[..., None]
        p = torch.where(mask, torch.exp(s - rows_lse), 0.0)
        del s, rows_lse
        delta = (doc * oc).sum(-1).permute(0, 2, 3, 1)[..., None]
        dv[:, :kend] += torch.einsum("bhgnk,bnhgd->bkhd", p, doc)
        ds = p * (torch.einsum("bnhgd,bkhd->bhgnk", doc, vc) - delta)
        del p
        dq[:, r0:r1] = torch.einsum("bhgnk,bkhd->bnhgd", ds, kc) * scale
        dk[:, :kend] += torch.einsum("bhgnk,bnhgd->bkhd", ds, qc) * scale
    if kv_len is not None or (causal and q_offset < 0):
        seen = torch.full((b, sq), skv, device=dev)
        if causal:
            qpos = torch.arange(sq, device=dev) + q_offset
            seen = torch.minimum(seen, (qpos + 1).clamp_min(0))
        if kv_len is not None:
            seen = torch.minimum(seen, kv_len.to(dev)[:, None])
        dead = (seen <= 0).to(f32)[:, :, None, None, None]
        if skv:
            lost = (dout.float().reshape(b, sq, hkv, g, d) * dead) \
                .sum(dim=(1, 3))
            dv += (lost / skv)[:, None]
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


flash_attention.launches = 0
flash_attention.launches_fp32 = 0
flash_attention.launches_bf16 = 0
flash_attention_backward.launches = 0

__all__ = ["flash_attention", "flash_attention_backward",
           "flash_attention_bwd", "flash_attention_ref", "attention_dense_ref",
           "flash_attention_split", "split_einsum", "launch_plan",
           "tile_rows", "bwd_tiles", "f32_kv_splits", "f32_tiles"]
