"""Mamba-2 SSD chunked scan (kernel B4): the CUDA kernel's wrapper and its
plain PyTorch versions, which mirror the reference's oracles
(``repro.kernels.ssd_scan.ref``) and its single-token step
(``repro.kernels.ssd_scan.ops.ssd_decode_step``).

Shapes (multi-head SSD, ngroups shared B/C like GQA):
  x:  (B, S, H, P)      dt: (B, S, H) fp32     A, D: (H,) fp32 (A < 0)
  Bm: (B, S, G, N)      Cm: (B, S, G, N)       state: (B, H, P, N) fp32

A CPU tensor goes to the plain versions, dispatched as the reference
dispatches (``ssd_ref`` when S is not a multiple of the chunk, else
``ssd_chunked_ref``); a CUDA tensor goes to the kernel in
``csrc/ssd_scan.cu`` for every S, or raises. ``ssd_split_ref`` repeats the
kernel's three passes and its split-bf16 products in plain PyTorch; no
dispatch reaches it."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_P, _MAX_N, _MAX_CHUNK = 64, 128, 4096


def _expand_groups(m: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N); head h reads group h // (H / G)."""
    b, s, g, n = m.shape
    return m[:, :, :, None, :].expand(b, s, g, h // g, n).reshape(b, s, h, n)


def ssd_ref(x, dt, A, Bm, Cm, D, init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle: y_t = C_t . h_t + D*x_t with
    h_t = exp(dt_t A) h_{t-1} + dt_t * B_t (x) x_t."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    Bh = _expand_groups(Bm, h).float()
    Ch = _expand_groups(Cm, h).float()
    xf = x.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                            # (B, H)
        dA = torch.exp(dtt * A)
        dBx = (dtt[..., None, None] * xf[:, t, :, :, None]) \
            * Bh[:, t, :, None, :]
        state = state * dA[..., None, None] + dBx         # (B, H, P, N)
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    y = y + xf * D[None, None, :, None]
    return y.to(x.dtype), state


def _segsum(t: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} t[..., k]; -inf above the diagonal."""
    s = t.shape[-1]
    cum = torch.cumsum(t, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=t.device))
    return torch.where(mask, diff, torch.full_like(diff, -float("inf")))


def ssd_chunked_ref(x, dt, A, Bm, Cm, D,
                    init_state: Optional[torch.Tensor] = None,
                    chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD block decomposition (arXiv:2405.21060 section 6): quadratic within
    chunks, linear recurrence across chunks. S % chunk == 0."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    assert s % chunk == 0, (s, chunk)
    c = s // chunk
    Bh = _expand_groups(Bm, h).float()
    Ch = _expand_groups(Cm, h).float()
    xf = x.float()
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                 device=x.device)
    xc = xf.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h).float()
    Bc = Bh.reshape(b, c, chunk, h, n)
    Cc = Ch.reshape(b, c, chunk, h, n)

    dA = dtc * A                                      # (B, C, Q, H)
    dA_cum = torch.cumsum(dA, dim=2)
    dA_tot = dA_cum[:, :, -1]                         # (B, C, H)

    # 1) intra-chunk
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))    # (B, C, H, Q, Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc) * L
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, dtc[..., None] * xc)

    # 2) chunk states
    decay_end = torch.exp(dA_tot[:, :, None, :] - dA_cum)    # (B, C, Q, H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bc * (decay_end * dtc)[..., None], xc)

    # 3) inter-chunk recurrence, keeping the state entering each chunk
    prev = init_state.float()
    entry = []
    for ci in range(c):
        entry.append(prev)
        prev = prev * torch.exp(dA_tot[:, ci])[..., None, None] \
            + states[:, ci]
    entry_states = torch.stack(entry, dim=1)          # (B, C, H, P, N)

    # 4) inter-chunk output from the entering state
    decay_in = torch.exp(dA_cum)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cc * decay_in[..., None],
                           entry_states)
    y = (y_intra + y_inter).reshape(b, s, h, p) + xf * D[None, None, :, None]
    return y.to(x.dtype), prev


def _split_dot(eq: str, exact: torch.Tensor, v: torch.Tensor,
               split: bool) -> torch.Tensor:
    """einsum(eq, exact, v) in fp32; with ``split``, v (fp32) is taken as
    hi = bf16(v) and lo = bf16(v - hi) in two products against the
    bf16-exact ``exact``, as the kernel's tensor-core passes take it."""
    if not split:
        return torch.einsum(eq, exact, v)
    hi = v.bfloat16().float()
    lo = (v - hi).bfloat16().float()
    return torch.einsum(eq, exact, hi) + torch.einsum(eq, exact, lo)


def ssd_split_ref(x, dt, A, Bm, Cm, D,
                  init_state: Optional[torch.Tensor] = None,
                  chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's numerics in plain PyTorch, for any S: its three
    passes (chunk states, the carry across chunks, outputs), the cumsum of
    dt * A summed in double and rounded to fp32, and for bf16 inputs each
    product with an fp32 operand (the decayed x, the entering state, the
    masked scores) split into bf16 hi and lo parts (``_split_dot``); C B^T
    is exact. A ragged last chunk is padded with dt = 0, x = 0."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    c = -(-s // q)
    pad = c * q - s
    split = x.dtype == torch.bfloat16

    def chunks(t):                      # (B, S, ...) -> (B, C, Q, ...)
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, c, q, *t.shape[2:])
    xc = chunks(x)                                    # (B, C, Q, H, P)
    dtc = chunks(dt)                                  # (B, C, Q, H)
    Bc = chunks(_expand_groups(Bm, h))                # (B, C, Q, H, N)
    Cc = chunks(_expand_groups(Cm, h))
    cum = torch.cumsum((dtc * A).double(), dim=2).float()
    cum_last = cum[:, :, -1]                          # (B, C, H)

    # 1) each chunk's own state: x scaled by its decay to the chunk's end
    xs = xc * (torch.exp(cum_last[:, :, None] - cum) * dtc)[..., None]
    own = _split_dot("bcqhn,bcqhp->bchpn", Bc, xs, split)
    # 2) the carry: the state entering each chunk
    prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    entry = []
    for ci in range(c):
        entry.append(prev)
        prev = prev * torch.exp(cum_last[:, ci])[..., None, None] \
            + own[:, ci]
    entry = torch.stack(entry, dim=1)                 # (B, C, H, P, N)
    # 3) outputs
    y_inter = _split_dot("bcqhn,bchpn->bcqhp", Cc, entry, split) \
        * torch.exp(cum)[..., None]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    cq = cum.permute(0, 1, 3, 2)                      # (B, C, H, Q)
    seg = cq[..., :, None] - cq[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask, seg, torch.full_like(seg,
                                                             -float("inf"))))
    scores = scores * decay * dtc.permute(0, 1, 3, 2)[..., None, :]
    y_intra = _split_dot("bckhp,bchqk->bcqhp", xc, scores, split)
    y = (y_intra + y_inter).reshape(b, c * q, h, p)[:, :s] \
        + x.float() * D[None, None, :, None]
    return y.to(x.dtype), prev


def ssd_decode_step(state, x, dt, A, Bm, Cm, D
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state: (B, H, P, N); x: (B, H, P); dt: (B, H);
    Bm/Cm: (B, G, N). Returns (y (B, H, P) in x's type, new_state fp32)."""
    h = x.shape[1]
    Bh = _expand_groups(Bm[:, None], h)[:, 0].float()     # (B, H, N)
    Ch = _expand_groups(Cm[:, None], h)[:, 0].float()
    dA = torch.exp(dt * A)
    dBx = (dt[..., None, None] * x.float()[..., None]) * Bh[:, :, None, :]
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) \
        + x.float() * D[None, :, None]
    return y.to(x.dtype), new_state


def ssd_scan(x, dt, A, Bm, Cm, D, init_state: Optional[torch.Tensor] = None,
             *, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD (prefill). Returns (y like x, final state (B, H, P,
    N) fp32). On CUDA the kernel takes any S: the within-chunk decay
    restarts every ``chunk`` positions as in ``ssd_chunked_ref``, and a
    ragged last chunk acts as if its missing positions had dt = 0 and
    x = 0, which is the recurrence's own result. On CUDA it refuses, with
    a RuntimeError, an input that requires grad while grad mode is on: the
    kernel has no backward yet."""
    s = x.shape[1]
    if x.device.type == "cpu":
        chunk = min(chunk, s)
        if s % chunk:
            return ssd_ref(x, dt, A, Bm, Cm, D, init_state)
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, init_state, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, init_state)):
        raise RuntimeError(
            "ssd_scan: kernel B4 has no backward on CUDA yet (ROADMAP.md, "
            "queue B, 'Backward for B4 and B1'); run under torch.no_grad(),"
            " or train Mamba-2 and hybrid models on the CPU")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    b, _, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (b, s) or g == 0 or h % g:
        raise ValueError(f"ssd_scan: Bm {tuple(Bm.shape)} does not match x "
                         f"{tuple(x.shape)} in groups of heads")
    if dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)} for x "
                         f"{tuple(x.shape)}")
    if p > _MAX_P or n > _MAX_N or p % 16 or n % 16:
        raise ValueError(f"ssd_scan: head dim {p} and state {n} must be "
                         f"multiples of 16 up to {_MAX_P} and {_MAX_N}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/Bm/Cm dtypes {x.dtype}/{Bm.dtype}/"
                        f"{Cm.dtype}; one of {_DTYPES}, all alike, expected")
    f32 = [dt, A, D] + ([] if init_state is None else [init_state])
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("ssd_scan: dt, A, D and init_state must be float32")
    if init_state is not None and init_state.shape != (b, h, p, n):
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)} "
                         f"is not {(b, h, p, n)}")
    if not all(t.device == x.device and t.is_contiguous()
               for t in [x, Bm, Cm] + f32) or any(
                   t.data_ptr() % 16 for t in [x, Bm, Cm] + f32[3:]):
        raise ValueError("ssd_scan: inputs must be contiguous on one device"
                         " (x, Bm, Cm and init_state 16-byte aligned)")
    chunk = min(int(chunk), s)
    if not 0 < chunk <= _MAX_CHUNK:
        raise ValueError(f"ssd_scan: S {s}, chunk {chunk}: need S > 0 and "
                         f"the chunk in (0, {_MAX_CHUNK}]")
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # scratch of the kernel's passes: each chunk's own state, the state
    # entering it, and its cumsum of dt * A
    nc = -(-s // chunk)
    states = torch.empty((2, b, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty((b, h, nc, chunk), dtype=torch.float32,
                      device=x.device)
    _build.module().ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), states[0].data_ptr(),
        states[1].data_ptr(), cum.data_ptr(), b, s, h, p, g, n, chunk,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0

__all__ = ["ssd_scan", "ssd_ref", "ssd_chunked_ref", "ssd_split_ref",
           "ssd_decode_step"]
