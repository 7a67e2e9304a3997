"""Mamba-2 SSD chunked scan (kernel B4): the CUDA kernel's wrapper and its
plain PyTorch versions, which mirror the reference's oracles
(``repro.kernels.ssd_scan.ref``) and its single-token step
(``repro.kernels.ssd_scan.ops.ssd_decode_step``).

Shapes (multi-head SSD, ngroups shared B/C like GQA):
  x:  (B, S, H, P)      dt: (B, S, H) fp32     A, D: (H,) fp32 (A < 0)
  Bm: (B, S, G, N)      Cm: (B, S, G, N)       state: (B, H, P, N) fp32

A CPU tensor goes to the plain versions, dispatched as the reference
dispatches (``ssd_ref`` when S is not a multiple of the chunk, else
``ssd_chunked_ref``), and trains by autograd of them, as the reference by
XLA's autodiff; a CUDA tensor goes to the kernel in ``csrc/ssd_scan.cu``
for every S, or raises, and trains through the backward kernel in
``csrc/ssd_scan_bwd.cu`` (``ssd_scan_backward``), whose plain version is
``ssd_scan_bwd``, the gradient in closed form. ``ssd_split_ref`` repeats
the forward kernel's three passes and its split-bf16 products in plain
PyTorch, and ``ssd_scan_bwd(..., split=True)`` the backward kernel's;
no dispatch reaches either."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, refuse_dtensor

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


def ssd_scan_bwd(x, dt, A, Bm, Cm, D, init_state, dy, dfinal, *,
                 chunk: int, block_elems: int = 1 << 26,
                 split: bool = False):
    """Gradients (dx, ddt, dA, dBm, dCm, dD, dinit) of ``ssd_scan`` for the
    output gradient ``dy`` and the final state's gradient ``dfinal`` (None:
    zero), in closed form, in fp32, returned in the inputs' types (dt, A,
    D and dinit fp32): the gradient the reference's autodiff takes of
    ``ssd_chunked_ref`` (``ssd_ref`` at a ragged S). ``dinit`` is the
    gradient of the state entering the first chunk, also when
    ``init_state`` is None (a zero state). A ragged last chunk is padded
    with dt = 0, x = 0, as the forward does.

    Per chunk of Q positions, with a_i = dt_i A, cum_i = sum_{k <= i} a_k
    (restarting at the chunk), cum_L = cum at the chunk's end, E the state
    entering the chunk and G the gradient of the state leaving it, the
    forward is
      y_i  = sum_{j <= i} (C_i . B_j) e_ij dt_j x_j + exp(cum_i) E C_i
             + D x_i,                       e_ij = exp(cum_i - cum_j)
      E'   = exp(cum_L) E + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T.
    The reverse carry walks the chunks backwards from G = dfinal:
      dE   = exp(cum_L) G + sum_i exp(cum_i) dy_i C_i^T,
    which is the G of the chunk before; ``dinit`` is the first chunk's dE.
    Then, each chunk alone, with S_ij = (C_i . B_j) e_ij, M_ij = (dy_i .
    x_j) dt_j e_ij (both 0 above the diagonal), R_ij = S_ij (dy_i . x_j),
    W_ij = R_ij dt_j, t_j = exp(cum_L - cum_j) and v_j = t_j x_j^T G B_j:
      dx_j  = dt_j (sum_i S_ij dy_i + t_j G B_j) + D dy_j
      dB_j  = sum_i M_ij C_i + t_j dt_j G^T x_j
      dC_i  = sum_j M_ij B_j + exp(cum_i) E^T dy_i
      ddt_j = sum_i R_ij + v_j                      (dt as a factor)
    and the gradient of each cum_i, from the masked scores, y_inter and the
    state update,
      dcum_i = sum_j W_ij - sum_k W_ki + C_i . (exp(cum_i) E^T dy_i)
               - dt_i v_i,
    plus, at the chunk's last position, sum_j dt_j v_j + exp(cum_L) <E, G>.
    A reverse cumsum within the chunk turns it into the gradient of each
    a_k = dt_k A: ddt_k += A da_k, dA = sum dt_k da_k; dD = sum x . dy. dB
    and dC sum over each group's H / G heads.

    Chunks go in blocks whose (B, chunks, H, Q, Q) score tensors hold at
    most ``block_elems`` values.

    ``split`` takes the backward kernel's numerics for bf16 inputs: the
    cumsum of dt * A summed in double and rounded to fp32, the entering
    states as the forward kernel carries them (``ssd_split_ref``), and
    each product with an fp32 operand (the decayed dy of the reverse
    carry, E, G, the masked scores M and S) as bf16 hi and lo parts against
    the exact other operand (``_split_dot``); C B^T and dy x^T are exact.
    Its inputs are bf16 (or fp32 holding bf16 values, for gradients in fp32
    without the outputs' rounding)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(int(chunk), s)
    c = -(-s // q)
    pad = c * q - s
    dev, f32 = x.device, torch.float32

    def chunks(t):                      # (B, S, ...) -> (B, C, Q, ...)
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, c, q, *t.shape[2:])
    xc, dyc, dtc = chunks(x), chunks(dy), chunks(dt)  # (B, C, Q, H[, P])
    Bc = chunks(_expand_groups(Bm, h))                # (B, C, Q, H, N)
    Cc = chunks(_expand_groups(Cm, h))
    if split:
        cum = torch.cumsum((dtc * A.float()).double(), dim=2).float()
    else:
        cum = torch.cumsum(dtc * A.float(), dim=2)    # (B, C, Q, H)
    last = cum[:, :, -1]                              # (B, C, H)
    to_end = torch.exp(last[:, :, None] - cum)        # t_j

    # the states entering each chunk, as the forward carries them
    own = _split_dot("bcqhn,bcqhp->bchpn", Bc,
                     xc * (to_end * dtc)[..., None], split)
    entry = [torch.zeros((b, h, p, n), dtype=f32, device=dev)
             if init_state is None else init_state.float()]
    for ci in range(c - 1):
        entry.append(entry[-1] * torch.exp(last[:, ci])[..., None, None]
                     + own[:, ci])
    E = torch.stack(entry, dim=1)                     # (B, C, H, P, N)
    del own, entry
    # the reverse carry: G, the gradient of the state leaving each chunk
    dy_in = _split_dot("bcqhn,bcqhp->bchpn", Cc,
                       dyc * torch.exp(cum)[..., None], split)
    G = torch.zeros((b, h, p, n), dtype=f32, device=dev) \
        if dfinal is None else dfinal.float()
    leave = [None] * c
    for ci in reversed(range(c)):
        leave[ci] = G
        G = G * torch.exp(last[:, ci])[..., None, None] + dy_in[:, ci]
    dinit = G
    Gl = torch.stack(leave, dim=1)                    # (B, C, H, P, N)
    del dy_in, leave

    dx = torch.empty_like(xc)
    dBh, dCh = torch.empty_like(Bc), torch.empty_like(Cc)
    ddt, dcum = torch.empty_like(dtc), torch.empty_like(dtc)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    Dv = D.float()[:, None]
    step = max(1, block_elems // max(1, b * h * q * q))
    for c0 in range(0, c, step):
        sl = slice(c0, min(c, c0 + step))
        x_, dy_, dt_, B_, C_ = xc[:, sl], dyc[:, sl], dtc[:, sl], \
            Bc[:, sl], Cc[:, sl]
        cm, te, E_, G_ = cum[:, sl], to_end[:, sl], E[:, sl], Gl[:, sl]
        cq = cm.permute(0, 1, 3, 2)                   # (B, c, H, Q)
        e = torch.exp(torch.where(mask, cq[..., :, None] - cq[..., None, :],
                                  -float("inf")))     # [.., i, j]
        dtj = dt_.permute(0, 1, 3, 2)[..., None, :]
        dyx = torch.einsum("bcihp,bcjhp->bchij", dy_, x_)
        S = torch.einsum("bcihn,bcjhn->bchij", C_, B_) * e
        M = dyx * e * dtj
        R = S * dyx
        W = R * dtj
        del e
        dC_int = _split_dot("bcihp,bchpn->bcihn", dy_, E_, split) \
            * torch.exp(cm)[..., None]
        GB = _split_dot("bcjhn,bchpn->bcjhp", B_, G_, split)
        dCh[:, sl] = _split_dot("bcjhn,bchij->bcihn", B_, M, split) + dC_int
        dBh[:, sl] = _split_dot("bcihn,bchij->bcjhn", C_, M, split) \
            + (te * dt_)[..., None] \
            * _split_dot("bcjhp,bchpn->bcjhn", x_, G_, split)
        dx[:, sl] = dt_[..., None] * (
            _split_dot("bcihp,bchij->bcjhp", dy_, S, split)
            + te[..., None] * GB) + Dv * dy_
        v = te * (x_ * GB).sum(-1)                    # (B, c, Q, H)
        u = dt_ * v
        ddt[:, sl] = R.sum(-2).permute(0, 1, 3, 2) + v
        dc = (W.sum(-1) - W.sum(-2)).permute(0, 1, 3, 2) \
            + (C_ * dC_int).sum(-1) - u
        dc[:, :, -1] += u.sum(2) + torch.exp(last[:, sl]) \
            * (E_ * G_).sum((-2, -1))
        dcum[:, sl] = dc
        del S, M, R, W, dyx
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + A.float() * da
    dA = (dtc * da).sum((0, 1, 2))
    dD = (xc * dyc).sum((0, 1, 2, 4))

    def unchunk(t):
        return t.reshape(b, c * q, *t.shape[3:])[:, :s]
    return (unchunk(dx).to(x.dtype), unchunk(ddt).contiguous(), dA,
            unchunk(dBh).reshape(b, s, g, h // g, n).sum(3).to(Bm.dtype),
            unchunk(dCh).reshape(b, s, g, h // g, n).sum(3).to(Cm.dtype),
            dD, dinit)


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
    """Full-sequence SSD (prefill and training). Returns (y like x, final
    state (B, H, P, N) fp32). On CUDA the kernel takes any S: the
    within-chunk decay restarts every ``chunk`` positions as in
    ``ssd_chunked_ref``, and a ragged last chunk acts as if its missing
    positions had dt = 0 and x = 0, which is the recurrence's own result.
    On CUDA, when grad mode is on and an input requires grad, it runs
    under ``_SSDScan``: the forward kernel, and the backward kernel
    (``ssd_scan_backward``) as its backward. A DTensor is refused with a
    TypeError (``refuse_dtensor``)."""
    refuse_dtensor("ssd_scan", x, dt, A, Bm, Cm, D, init_state)
    s = x.shape[1]
    if x.device.type == "cpu":
        chunk = min(chunk, s)
        if s % chunk:
            return ssd_ref(x, dt, A, Bm, Cm, D, init_state)
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, init_state, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    chunk = _check(x, dt, A, Bm, Cm, D, init_state, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, init_state)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, D, init_state, chunk)
    return _launch(x, dt, A, Bm, Cm, D, init_state, chunk)[:2]


def _check(x, dt, A, Bm, Cm, D, init_state, chunk) -> int:
    """Raise on what the kernel does not take; return the chunk it runs
    (``min(chunk, S)``)."""
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    b, s, h, p = x.shape
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
    return chunk


def _launch(x, dt, A, Bm, Cm, D, init_state, chunk):
    """Launch the forward kernel on checked inputs and count the launch.
    Returns (y, final state, entry, cum): the state entering each chunk
    (B, H, ceil(S / chunk), P, N) (for bf16 inputs as bf16 hi and lo
    tiles in each slot's bytes) and the chunks' cumsums of dt * A (B, H,
    ceil(S / chunk), chunk), the scratch the backward kernel reads."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # scratch of the kernel's passes: each chunk's own state, the state
    # entering it, and its cumsum of dt * A
    nc = -(-s // chunk)
    own, entry = (torch.empty((b, h, nc, p, n), dtype=torch.float32,
                              device=x.device) for _ in range(2))
    cum = torch.empty((b, h, nc, chunk), dtype=torch.float32,
                      device=x.device)
    _build.module().ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), own.data_ptr(), entry.data_ptr(),
        cum.data_ptr(), b, s, h, p, g, n, chunk,
        int(x.dtype == torch.bfloat16),
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    ssd_scan.launches += 1
    return y, final, entry, cum


class _SSDScan(torch.autograd.Function):
    """B4 under autograd: the forward kernel, and the backward kernel
    (``ssd_scan_backward``) as its backward, which reads the forward's
    entering states and cumsums (saved here; each chunk's own state is
    not). The reference has no backward kernel: its gradient is XLA's
    autodiff of the jnp ``ssd_chunked_ref``. A final state nobody reads
    gets no gradient (None, as zero)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state, chunk):
        y, final, entry, cum = _launch(x, dt, A, Bm, Cm, D, init_state,
                                       chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, entry, cum)
        ctx.chunk, ctx.has_init = chunk, init_state is not None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, D, entry, cum = ctx.saved_tensors
        grads = ssd_scan_backward(
            x, dt, A, Bm, Cm, D, torch.zeros_like(x) if dy is None else dy,
            dfinal, entry, cum, chunk=ctx.chunk)
        if not ctx.has_init:
            grads = grads[:6] + (None,)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy only if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# CTAs of the backward's passes 3 and 4 that keep the card busy: past
# this, a CTA takes several heads of a group (``_heads_per_cta``)
_FILL_CTAS = 1024


def _heads_per_cta(b, h, g, nc, n_t) -> int:
    """Heads a CTA of the bf16 backward's passes 3 and 4 takes: 4 or 2 of
    one group's, where that still leaves ``_FILL_CTAS`` CTAs, else 1."""
    for hs in (4, 2):
        if (h // g) % hs == 0 and b * (h // hs) * nc * n_t >= _FILL_CTAS:
            return hs
    return 1


def ssd_scan_backward(x, dt, A, Bm, Cm, D, dy, dfinal, entry, cum, *,
                      chunk: int):
    """Kernel B4's backward on CUDA (``csrc/ssd_scan_bwd.cu``), the
    backward of ``_SSDScan``: the gradients (dx, ddt, dA, dBm, dCm, dD,
    dinit) that ``ssd_scan_bwd`` computes in PyTorch ops (for bf16 inputs
    with ``split=True``'s numerics), from inputs the forward kernel took
    (``chunk`` as it ran, ``min(chunk, S)``), the output gradient ``dy``,
    the final state's gradient ``dfinal`` (None: zero) and the forward's
    scratch ``entry`` and ``cum`` (``_launch``). For bf16 inputs a CTA of
    passes 3 and 4 takes ``_heads_per_cta`` of a group's heads, which sets
    the order of dB's and dC's sums over heads, not what they sum. Counts
    its launch in ``ssd_scan_backward.launches``."""
    refuse_dtensor("ssd_scan_backward", x, dt, A, Bm, Cm, D, dy, dfinal,
                   entry, cum)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_backward: unsupported device {x.device}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc = -(-s // chunk)
    if entry.shape != (b, h, nc, p, n) or cum.shape != (b, h, nc, chunk):
        raise ValueError(f"ssd_scan_backward: scratch {tuple(entry.shape)},"
                         f" {tuple(cum.shape)} is not the forward's for x "
                         f"{tuple(x.shape)} and chunk {chunk}")
    if dy.shape != x.shape or (dfinal is not None
                               and dfinal.shape != (b, h, p, n)):
        raise ValueError(f"ssd_scan_backward: dy {tuple(dy.shape)}, dfinal "
                         f"{None if dfinal is None else tuple(dfinal.shape)}"
                         f" for x {tuple(x.shape)}")
    dy = _aligned(dy.to(x.dtype))
    dfinal = None if dfinal is None else _aligned(dfinal.float())
    dev, f32 = x.device, torch.float32
    dx, dBm, dCm = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dA, dD = (torch.empty((h,), dtype=f32, device=dev) for _ in range(2))
    dinit = torch.empty((b, h, p, n), dtype=f32, device=dev)
    # scratch: per chunk the reverse carry's product, and the gradient of
    # the state leaving it; dB and dC of each slice of hs heads; per
    # position the parts of the decay's gradient; per chunk dA's and dD's
    # parts and each carry CTA's part
    bf16 = x.dtype == torch.bfloat16
    hs = _heads_per_cta(b, h, g, nc, -(-chunk // 64)) if bf16 else 1
    gst = torch.empty((2, b, h, nc, p, n), dtype=f32, device=dev)
    dbch = torch.empty((2, b, s, h // hs, n), dtype=f32, device=dev)
    rows = torch.empty((4, b, h, nc, chunk), dtype=f32, device=dev)
    sums = torch.empty((b * h * nc * (2 + -(-p * n // 512)),), dtype=f32,
                       device=dev)
    _build.module().ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), entry.data_ptr(),
        cum.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dBm.data_ptr(), dCm.data_ptr(), dD.data_ptr(), dinit.data_ptr(),
        gst.data_ptr(), dbch.data_ptr(), rows.data_ptr(), sums.data_ptr(),
        b, s, h, p, g, n, chunk, hs, int(bf16),
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    ssd_scan_backward.launches += 1
    return dx, ddt, dA, dBm, dCm, dD, dinit


ssd_scan.launches = 0
ssd_scan_backward.launches = 0

__all__ = ["ssd_scan", "ssd_scan_backward", "ssd_scan_bwd", "ssd_ref",
           "ssd_chunked_ref", "ssd_split_ref", "ssd_decode_step"]
