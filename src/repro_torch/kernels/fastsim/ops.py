"""The compiled whole-trace simulation core of the Scenario API: the CUDA
kernel's wrapper and its plain version.

``whole_trace`` runs the colocated heartbeat loop for a fixed fleet with
inert KV and ``aladdin``/``jsq`` placement over a whole trace: admission,
the EDF sort of the backlog (multi-tenant traces), the placement pass with
Algorithm 1's constraints (b)-(d) (their tagged per-request form when the
trace carries per-request SLO budgets), the event skip over arrival-free
beats, every worker's prefill/decode segments, the finisher drain, the
beat count of the final drain and the flush of still-running rows. It is
the counterpart of the reference's jit core
(``repro.serving.fastsim_jax._make_simulate``); ``n_active`` may be a
vector of candidate fleet sizes, which takes the place of the reference's
``vmap``.

A CPU tensor goes to ``whole_trace_plain``; a CUDA tensor goes to the
kernel in ``csrc/whole_trace.cu`` (one launch, one CTA per candidate) or
raises. There is no fallback between the two.

Numerics follow the numpy core (``serving/fastsim.py``), which is bit for
bit equal to the reference engine: sequential left-associated adds,
``t += hb`` per skipped beat, ``k2*C + c2*b + c3`` grouped as
``((k2*C) + (c2*b)) + c3``, no fused multiply-adds, and the capacity norm
through CPython's ``math.hypot``. Two places differ from the jit core, to
follow the numpy core: a decode segment closes at every beat end, also at
those the event skip covers (the jit core lets a segment run across them,
which rounds ``t_decode_spent`` differently in the last ulps), and the
final drain counts its beats up to the one in which the last request
finished, where a stepwise loop stops (the jit core estimates that beat
from the last finish time, one more where the finish overshoots a beat
end). The plain version keeps its state in Python floats and ints, which
are IEEE doubles and exact integers."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

_INF = math.inf
_NAN = math.nan
_POLICIES = ("aladdin", "jsq")


def _simulate(arr, l_in, l_real, na, rank, ttft_r, atgt_r, *, hb, horizon,
              theta, gamma, ttft, atgt, policy, coefs, maxb, maxb_norm,
              cmax_norm, edf, tagged):
    """One candidate (``na`` workers alive of ``len(maxb)``) over the whole
    trace; the lists in, Python scalars throughout."""
    n, W = len(arr), len(maxb)
    B = max(max(maxb), 1)
    K1, C1, K2, C2, C3 = coefs
    is_aladdin = policy == "aladdin"
    tag_a = tagged and is_aladdin
    alive = [w < na for w in range(W)]

    mem = [[-1] * B for _ in range(W)]
    active = [[False] * B for _ in range(W)]
    started = [[False] * B for _ in range(W)]
    lane_li = [[0] * B for _ in range(W)]
    lane_lr = [[0] * B for _ in range(W)]
    lane_lo = [[0] * B for _ in range(W)]
    lane_tds = [[0.0] * B for _ in range(W)]
    lane_tf1 = [[_NAN] * B for _ in range(W)]
    lane_tfn = [[_NAN] * B for _ in range(W)]
    lane_t = [0.0] * W
    out_lo = [0] * n
    out_tds = [0.0] * n
    out_tf1 = [_NAN] * n
    out_tfn = [_NAN] * n

    def place_pass(q):
        d_budget = [0.0] * W
        d_budget_t = [0.0] * W
        amin = [_INF] * W
        tmin = [_INF] * W
        wctx = [0.0] * W
        newsum = [0] * W
        cnt = [0] * W
        for w in range(W):
            slack = slack_t = _INF
            for s in range(B):
                if not active[w][s]:
                    continue
                rid = mem[w][s]
                if started[w][s]:
                    m = max(lane_lo[w][s] - 1, 0)
                    slack = min(slack, atgt * m - lane_tds[w][s])
                    if tag_a:
                        am = atgt_r[rid]
                        am = atgt if am == _INF else am
                        slack_t = min(slack_t, am * m - lane_tds[w][s])
                else:
                    newsum[w] += lane_li[w][s]
                    if tag_a:
                        tmin[w] = min(tmin[w], ttft_r[rid])
                if tag_a:
                    amin[w] = min(amin[w], atgt_r[rid])
                wctx[w] += lane_li[w][s] + gamma * lane_lr[w][s]
                cnt[w] += 1
            if is_aladdin:
                d_budget[w] = theta * max(slack, 0.0)
                d_budget_t[w] = theta * max(slack_t, 0.0)
        keep = []
        for rid in q:
            liv, lrv = l_in[rid], l_real[rid]
            v = liv + gamma * lrv
            best, best_key = -1, None
            for w in range(W):
                bpost = cnt[w] + 1
                if not (alive[w] and bpost <= maxb[w]):
                    continue
                if is_aladdin:
                    a_eff, t_eff, d_eff = atgt, ttft, d_budget[w]
                    if tag_a and atgt_r[rid] != _INF:
                        # an untagged candidate takes the scalar branch
                        a0 = min(amin[w], atgt_r[rid])
                        a_eff = atgt if a0 == _INF else a0
                        t0 = min(tmin[w], ttft_r[rid])
                        t_eff = ttft if t0 == _INF else t0
                        d_eff = d_budget_t[w]
                    budget = (max(((a_eff - C3[w]) - C2[w] * bpost) / K2[w],
                                  0.0) if K2[w] > 0 else _INF)
                    pre_t = K1[w] * (newsum[w] + liv) + C1[w]
                    if not (wctx[w] + v <= theta * budget
                            and pre_t <= t_eff and pre_t <= d_eff):
                        continue
                    # best fit: the largest capacity norm, ties to the
                    # lowest index
                    key = math.hypot(cnt[w] / maxb_norm[w],
                                     wctx[w] / cmax_norm[w])
                    if best < 0 or key > best_key:
                        best, best_key = w, key
                elif best < 0 or cnt[w] < best_key:
                    # jsq: the smallest batch, ties to the lowest index
                    best, best_key = w, cnt[w]
            if best < 0:
                keep.append(rid)        # stays queued, FIFO order kept
                continue
            w = best
            s = active[w].index(False)
            mem[w][s] = rid
            active[w][s], started[w][s] = True, False
            lane_li[w][s], lane_lr[w][s], lane_lo[w][s] = liv, lrv, 0
            lane_tds[w][s] = 0.0
            lane_tf1[w][s] = lane_tfn[w][s] = _NAN
            cnt[w] += 1
            newsum[w] += liv
            wctx[w] += v
            if tag_a:
                amin[w] = min(amin[w], atgt_r[rid])
                tmin[w] = min(tmin[w], ttft_r[rid])
        return keep

    def segments(w, t_end):
        """Worker ``w``'s ``advance_to(t_end)``: prefill or decode segments
        until its clock reaches ``t_end``. Returns whether a request
        finished."""
        k1, c1, k2, c2, c3 = K1[w], C1[w], K2[w], C2[w], C3[w]
        act, sta = active[w], started[w]
        li, lr, lo = lane_li[w], lane_lr[w], lane_lo[w]
        rtds, rtf1, rtfn = lane_tds[w], lane_tf1[w], lane_tfn[w]
        tl = lane_t[w]
        fin = False
        while tl < t_end:
            new = [s for s in range(B) if act[s] and not sta[s]]
            if new:
                # joint prefill of the new batch; decode stalls
                dur_p = k1 * sum(li[s] for s in new) + c1
                t_pre = tl + dur_p
                for s in range(B):
                    if act[s] and sta[s]:
                        rtds[s] = rtds[s] + dur_p
                for s in new:
                    rtf1[s] = t_pre
                    lo[s] = 1
                    sta[s] = True
                tl = t_pre
                continue
            on = [s for s in range(B) if act[s]]
            if not on:
                tl = t_end
                continue
            # decode: the batch is fixed until the next finish boundary
            b = len(on)
            c0 = sum(li[s] + lo[s] for s in on)
            n_fin = min(max(lr[s] - lo[s], 1) for s in on)
            cb = c2 * b
            k, td, seg = 0, tl, 0.0
            while k < n_fin and td < t_end:
                dur = k2 * (c0 + k * b) + cb + c3
                k += 1
                td += dur
                seg += dur
            for s in on:
                lo[s] += k
                rtds[s] = rtds[s] + seg
                if lo[s] >= lr[s]:
                    rtfn[s] = td
                    act[s] = False
                    rid = mem[w][s]
                    out_lo[rid], out_tds[rid] = lo[s], rtds[s]
                    out_tf1[rid], out_tfn[rid] = rtf1[s], td
                    fin = True
            tl = td
        lane_t[w] = tl
        return fin

    def advance(w, t, k_steps, t_next):
        """Worker ``w`` through the ``k_steps`` beats that end at
        ``t + hb``, ``t + hb + hb``, ... ``t_next``. Each beat end closes
        a decode segment, as it does when the beats are stepped one at a
        time, so ``t_decode_spent`` sums the same partial segments as the
        numpy core; an idle worker jumps to ``t_next``. Returns the number
        of the last of those beats in which a request finished (0 for
        none)."""
        j_fin = 0
        for j in range(1, k_steps + 1):
            t += hb
            if segments(w, t):
                j_fin = j
            if not any(active[w]):
                lane_t[w] = max(lane_t[w], t_next)
                break
        return j_fin

    t, idx, q, beats = 0.0, 0, [], 0
    while t < horizon and not (idx >= n and not q
                               and not any(map(any, active))):
        while idx < n and arr[idx] <= t:    # the trace is sorted by arrival
            q.append(idx)
            idx += 1
        if edf:
            q.sort(key=rank.__getitem__)    # ranks are unique
        q = place_pass(q)
        # event skip: with an empty queue, step the beat clock with the
        # same sequential t += hb adds up to the next arrival, and cover
        # the gap with one advance per worker
        can_skip = not q
        next_arr = arr[idx] if idx < n else _INF
        k_steps, t_next = 0, t
        while (t_next < horizon and t_next < next_arr
               and (k_steps == 0 or can_skip)):
            k_steps += 1
            t_next += hb
        j_fin = max(advance(w, t, k_steps, t_next) for w in range(W))
        # the final drain runs to the horizon: count its beats up to the
        # one in which the last request finished, where a stepwise loop
        # stops
        drained = idx >= n and not any(map(any, active))
        beats += max(j_fin, 1) if drained and k_steps > 1 else k_steps
        t = t_next
    # flush still-running rows (partial clocks)
    for w in range(W):
        for s in range(B):
            if active[w][s]:
                rid = mem[w][s]
                out_lo[rid], out_tds[rid] = lane_lo[w][s], lane_tds[w][s]
                out_tf1[rid], out_tfn[rid] = lane_tf1[w][s], lane_tfn[w][s]
    return out_lo, out_tds, out_tf1, out_tfn, beats


def _statics_ok(n: int, coefs, maxb, maxb_norm, cmax_norm, policy) -> int:
    """Check the configuration; return the fleet width W."""
    W = len(maxb)
    if n < 1:
        raise ValueError("whole_trace: the trace is empty (an empty trace "
                         "needs no kernel)")
    if policy not in _POLICIES:
        raise ValueError(f"whole_trace: policy {policy!r} not in "
                         f"{_POLICIES}")
    if W < 1 or len(coefs) != 5 or any(len(c) != W for c in coefs) \
            or len(maxb_norm) != W or len(cmax_norm) != W:
        raise ValueError("whole_trace: coefs (5 x W), maxb, maxb_norm and "
                         "cmax_norm must all describe the same W >= 1 "
                         "workers")
    return W


def whole_trace_plain(arrival: torch.Tensor, l_in: torch.Tensor,
                      l_real: torch.Tensor, n_active, rank_r: torch.Tensor,
                      ttft_r: torch.Tensor, atgt_r: torch.Tensor, *,
                      hb: float, horizon: float, theta: float, gamma: float,
                      ttft: float, atgt: float, policy: str,
                      coefs: Sequence[Sequence[float]], maxb: Sequence[int],
                      maxb_norm: Sequence[float],
                      cmax_norm: Sequence[float], edf: bool = False,
                      tagged: bool = False) -> Tuple[torch.Tensor, ...]:
    """The plain version of ``whole_trace``, candidate after candidate.

    arrival (n,) float64, sorted; l_in, l_real, rank_r (n,) int64; ttft_r,
    atgt_r (n,) float64 (``inf`` = untagged); ``n_active`` an int, or a
    (C,) int64 tensor of candidate fleet sizes. The statics are those the
    reference's ``_make_simulate`` closes over: ``coefs`` the per-worker
    (k1, c1, k2, c2, c3), ``maxb`` the per-worker max batch, ``maxb_norm``
    and ``cmax_norm`` the capacity norm's denominators. ``edf`` sorts the
    backlog by ``rank_r`` every beat; ``tagged`` (with ``aladdin``) budgets
    constraints (b)-(d) against per-request SLOs.

    Returns (l_out int64, t_decode_spent, t_first_token, t_finish float64,
    beats int64), each with a leading candidate axis when ``n_active`` is a
    vector; unset times are NaN."""
    n = int(arrival.shape[0])
    _statics_ok(n, coefs, maxb, maxb_norm, cmax_norm, policy)
    batched = torch.is_tensor(n_active) and n_active.dim() == 1
    cands = (n_active.tolist() if batched else [int(n_active)])
    lists = [x.tolist() for x in (arrival, l_in, l_real, rank_r, ttft_r,
                                  atgt_r)]
    kw = dict(hb=float(hb), horizon=float(horizon), theta=float(theta),
              gamma=float(gamma), ttft=float(ttft), atgt=float(atgt),
              policy=policy,
              coefs=tuple([float(x) for x in c] for c in coefs),
              maxb=[int(x) for x in maxb],
              maxb_norm=[float(x) for x in maxb_norm],
              cmax_norm=[float(x) for x in cmax_norm], edf=bool(edf),
              tagged=bool(tagged))
    runs = [_simulate(lists[0], lists[1], lists[2], na, *lists[3:], **kw)
            for na in cands]
    dev = arrival.device
    outs = tuple(
        torch.tensor([r[i] for r in runs], dtype=dt, device=dev)
        for i, dt in enumerate((torch.int64, torch.float64, torch.float64,
                                torch.float64, torch.int64)))
    return outs if batched else tuple(o[0] for o in outs)


def _check(arrival, l_in, l_real, n_active, rank_r, ttft_r, atgt_r) -> None:
    """Raise for what the kernel does not take."""
    n = arrival.shape[0]
    want = ((arrival, torch.float64), (l_in, torch.int64),
            (l_real, torch.int64), (rank_r, torch.int64),
            (ttft_r, torch.float64), (atgt_r, torch.float64))
    for x, dt in want:
        if x.dtype != dt or x.shape != (n,) or x.device != arrival.device \
                or not x.is_contiguous():
            raise ValueError(f"whole_trace: every trace array must be a "
                             f"contiguous ({n},) tensor on {arrival.device}"
                             f"; got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device} where {dt} was expected")
    if n >= 2 ** 31:
        raise ValueError(f"whole_trace: {n} requests exceed the kernel's "
                         "int32 request ids")
    if n_active.dtype != torch.int64 or n_active.dim() != 1 \
            or n_active.device != arrival.device:
        raise ValueError("whole_trace: n_active must be a (C,) int64 "
                         "tensor on the trace's device")


def whole_trace(arrival: torch.Tensor, l_in: torch.Tensor,
                l_real: torch.Tensor, n_active, rank_r: torch.Tensor,
                ttft_r: torch.Tensor, atgt_r: torch.Tensor, *, hb: float,
                horizon: float, theta: float, gamma: float, ttft: float,
                atgt: float, policy: str, coefs: Sequence[Sequence[float]],
                maxb: Sequence[int], maxb_norm: Sequence[float],
                cmax_norm: Sequence[float], edf: bool = False,
                tagged: bool = False) -> Tuple[torch.Tensor, ...]:
    """See ``whole_trace_plain``. On CUDA: one launch of the kernel for all
    candidates and one synchronisation, when the outputs are read."""
    kw = dict(hb=hb, horizon=horizon, theta=theta, gamma=gamma, ttft=ttft,
              atgt=atgt, policy=policy, coefs=coefs, maxb=maxb,
              maxb_norm=maxb_norm, cmax_norm=cmax_norm, edf=edf,
              tagged=tagged)
    if not arrival.is_cuda:
        if arrival.device.type == "cpu":
            return whole_trace_plain(arrival, l_in, l_real, n_active,
                                     rank_r, ttft_r, atgt_r, **kw)
        raise ValueError(f"whole_trace: unsupported device {arrival.device}")
    n = int(arrival.shape[0])
    W = _statics_ok(n, coefs, maxb, maxb_norm, cmax_norm, policy)
    batched = torch.is_tensor(n_active) and n_active.dim() == 1
    cands = (n_active if batched else torch.tensor(
        [int(n_active)], dtype=torch.int64, device=arrival.device))
    _check(arrival, l_in, l_real, cands, rank_r, ttft_r, atgt_r)
    C = int(cands.shape[0])
    B = max(max(int(x) for x in maxb), 1)
    dev = arrival.device
    # per-worker parameters, one row each: k1, c1, k2, c2, c3, the two
    # capacity-norm denominators, and the max batch (exact in float64)
    par = torch.tensor([*(list(map(float, c)) for c in coefs),
                        list(map(float, maxb_norm)),
                        list(map(float, cmax_norm)),
                        list(map(float, maxb))], dtype=torch.float64,
                       device=dev)
    out_lo = torch.empty((C, n), dtype=torch.int64, device=dev)
    out_f = torch.empty((3, C, n), dtype=torch.float64, device=dev)
    beats = torch.empty((C,), dtype=torch.int64, device=dev)
    queue = torch.empty((C, n), dtype=torch.int32, device=dev)
    _build.module().whole_trace(
        arrival.data_ptr(), l_in.data_ptr(), l_real.data_ptr(),
        rank_r.data_ptr(), ttft_r.data_ptr(), atgt_r.data_ptr(),
        cands.data_ptr(), par.data_ptr(), out_lo.data_ptr(),
        out_f.data_ptr(), beats.data_ptr(), queue.data_ptr(), n, W, B, C,
        float(hb), float(horizon), float(theta), float(gamma), float(ttft),
        float(atgt), policy == "aladdin", bool(edf), bool(tagged),
        torch._C._cuda_getCurrentRawStream(arrival.get_device()))
    whole_trace.launches += 1
    outs = (out_lo, out_f[0], out_f[1], out_f[2], beats)
    return outs if batched else tuple(o[0] for o in outs)


whole_trace.launches = 0

__all__ = ["whole_trace", "whole_trace_plain"]
