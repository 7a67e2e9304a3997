"""The compiled simulation cores of the Scenario API: the CUDA kernels'
wrappers and their plain versions.

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

``chunk`` is the chunked core, everything else of the colocated envelope:
live KV (constraint (e)'s peak admission, overflow eviction, FIFO resume),
``po2`` placement, and fleets whose membership the host changes between
chunks (policy scaling, spot markets). It advances up to ``K`` beats of a
fixed fleet configuration from a packed state (two flat buffers, one
float64 and one int64, laid out by ``chunk_layout``) and returns the
advanced state; the host side (``serving/fastsim_jax.py``) settles the
fleet between chunks. It is the counterpart of the reference's
``_make_chunk`` and ``_advance_lane_kv``; a leading candidate axis takes
the place of the reference's ``vmap`` over policy candidates.

A CPU tensor goes to the plain version (``whole_trace_plain``,
``chunk_plain``); a CUDA tensor goes to the kernel in
``csrc/whole_trace.cu`` or ``csrc/chunk.cu`` (one launch, one CTA per
candidate) or raises. There is no fallback between the two.

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
end). And a worker's weighted context is summed as the numpy core sums it,
its ongoing requests in join order and then its new batch, where the jit
cores sum it in slot order: the terms ``l_in + gamma * l_real`` round for
a ``gamma`` with many significant bits (0.3), and then the order of their
sum shows in the last ulp, which can turn a best-fit choice. The plain
versions keep their state in Python floats and ints, which are IEEE
doubles and exact integers."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

_INF = math.inf
_NAN = math.nan
_POLICIES = ("aladdin", "jsq")


def _simulate(arr, l_in, l_real, na, rank, ttft_r, atgt_r, *, hb, horizon,
              theta, gamma, ttft, atgt, policy, coefs, maxb, maxb_norm,
              cmax_norm, edf, tagged, passes=None):
    """One candidate (``na`` workers alive of ``len(maxb)``) over the whole
    trace; the lists in, Python scalars throughout. ``passes`` is
    instrumentation for the tests alone (the check of the kernel's pruning
    rule in tests/test_torch_fastsim.py); nothing else passes it. A list,
    it receives each placement pass's tries in order: (weight l_in + gamma
    * l_real, l_in, whether the request carries its own ATGT budget,
    whether it was placed)."""
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
    lane_seq = [[0] * B for _ in range(W)]      # placement sequence
    lane_tds = [[0.0] * B for _ in range(W)]
    lane_tf1 = [[_NAN] * B for _ in range(W)]
    lane_tfn = [[_NAN] * B for _ in range(W)]
    lane_t = [0.0] * W
    out_lo = [0] * n
    out_tds = [0.0] * n
    out_tf1 = [_NAN] * n
    out_tfn = [_NAN] * n
    seqc = 0

    def place_pass(q):
        nonlocal seqc
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
                cnt[w] += 1
            # the weighted context in the numpy core's order: the ongoing
            # members in join order, then the new batch, i.e. every member
            # in placement order (a float sum, so the order shows in the
            # last ulp)
            for s in sorted((s for s in range(B) if active[w][s]),
                            key=lane_seq[w].__getitem__):
                wctx[w] += lane_li[w][s] + gamma * lane_lr[w][s]
            if is_aladdin:
                d_budget[w] = theta * max(slack, 0.0)
                d_budget_t[w] = theta * max(slack_t, 0.0)
        keep = []
        tries = [] if passes is not None else None
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
            if tries is not None:
                tries.append((v, liv, tag_a and atgt_r[rid] != _INF,
                              best >= 0))
            if best < 0:
                keep.append(rid)        # stays queued, FIFO order kept
                continue
            w = best
            s = active[w].index(False)
            mem[w][s], lane_seq[w][s] = rid, seqc
            seqc += 1
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
        if tries is not None:
            passes.append(tries)
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


# The whole-trace kernel's optional counters, one row of int64 per
# candidate (``whole_trace``'s ``stats``): SM cycles on the CTA's thread 0
# for the whole launch and for each phase of a loop iteration (admission
# and the EDF merge; the placement pass's tries, i.e. its rounds over the
# lanes, and its commits; the lanes' advance and their aggregates, each the
# slowest warp's; the barriers and the beat bookkeeping); loop iterations;
# beats; queued requests the placement pass tried; requests placed; the
# lanes' prefill and decode segments and decode iterations; recounts of a
# lane's weighted context; and the tries that an untagged request no larger
# (weighted context, prompt) than one that found no lane earlier in the
# pass settled without a round.
WHOLE_STATS = ("cycles", "admit_cycles", "try_cycles", "commit_cycles",
               "advance_cycles", "aggregate_cycles", "barrier_cycles",
               "iterations", "beats", "tried", "placed", "prefills",
               "decode_segments", "decode_iterations", "recounts",
               "dominated")


def whole_trace_scratch_bytes(n: int, W: int, B: int) -> int:
    """The global scratch a whole-trace launch needs for each candidate:
    the queue's two buffers of keys (16 B a request), then the lane state
    (members and tables, or lanes too) that does not fit in shared memory.
    It asks the built library, so it needs the card."""
    nbytes = int(_build.module().whole_trace_scratch(n, W, B))
    if nbytes < 16 * n:
        raise ValueError(f"whole_trace: {W} workers x max batch {B} exceed "
                         "the kernel's int32 offsets")
    return nbytes


def whole_trace(arrival: torch.Tensor, l_in: torch.Tensor,
                l_real: torch.Tensor, n_active, rank_r: torch.Tensor,
                ttft_r: torch.Tensor, atgt_r: torch.Tensor, *, hb: float,
                horizon: float, theta: float, gamma: float, ttft: float,
                atgt: float, policy: str, coefs: Sequence[Sequence[float]],
                maxb: Sequence[int], maxb_norm: Sequence[float],
                cmax_norm: Sequence[float], edf: bool = False,
                tagged: bool = False, stats: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """See ``whole_trace_plain``. On CUDA: one launch of the kernel for all
    candidates and one synchronisation, when the outputs are read.
    ``stats``, a (C, len(WHOLE_STATS)) int64 tensor on the card, receives
    the kernel's counters (``WHOLE_STATS``): the launch adds to it, so one
    tensor can gather several launches. The plain version has none."""
    kw = dict(hb=hb, horizon=horizon, theta=theta, gamma=gamma, ttft=ttft,
              atgt=atgt, policy=policy, coefs=coefs, maxb=maxb,
              maxb_norm=maxb_norm, cmax_norm=cmax_norm, edf=edf,
              tagged=tagged)
    if not arrival.is_cuda:
        if arrival.device.type == "cpu" and stats is None:
            return whole_trace_plain(arrival, l_in, l_real, n_active,
                                     rank_r, ttft_r, atgt_r, **kw)
        raise ValueError(f"whole_trace: unsupported device {arrival.device}"
                         ", or stats without the kernel")
    n = int(arrival.shape[0])
    W = _statics_ok(n, coefs, maxb, maxb_norm, cmax_norm, policy)
    batched = torch.is_tensor(n_active) and n_active.dim() == 1
    cands = (n_active if batched else torch.tensor(
        [int(n_active)], dtype=torch.int64, device=arrival.device))
    _check(arrival, l_in, l_real, cands, rank_r, ttft_r, atgt_r)
    C = int(cands.shape[0])
    if stats is not None and (
            stats.dtype != torch.int64 or stats.shape != (C, len(WHOLE_STATS))
            or stats.device != arrival.device or not stats.is_contiguous()):
        raise ValueError(f"whole_trace: stats must be a contiguous (C, "
                         f"{len(WHOLE_STATS)}) int64 tensor on "
                         f"{arrival.device}; got {tuple(stats.shape)} "
                         f"{stats.dtype} on {stats.device}")
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
    # the queue's two buffers of keys (the EDF merge writes the other), then
    # the lane state that shared memory does not hold
    scratch = torch.empty((C, whole_trace_scratch_bytes(n, W, B)),
                          dtype=torch.uint8, device=dev)
    _build.module().whole_trace(
        arrival.data_ptr(), l_in.data_ptr(), l_real.data_ptr(),
        rank_r.data_ptr(), ttft_r.data_ptr(), atgt_r.data_ptr(),
        cands.data_ptr(), par.data_ptr(), out_lo.data_ptr(),
        out_f.data_ptr(), beats.data_ptr(), scratch.data_ptr(),
        None if stats is None else stats.data_ptr(), n, W, B, C,
        float(hb), float(horizon), float(theta), float(gamma), float(ttft),
        float(atgt), policy == "aladdin", bool(edf), bool(tagged),
        torch._C._cuda_getCurrentRawStream(arrival.get_device()))
    whole_trace.launches += 1
    outs = (out_lo, out_f[0], out_f[1], out_f[2], beats)
    return outs if batched else tuple(o[0] for o in outs)


whole_trace.launches = 0


# ---- the chunked core ---------------------------------------------------------
#
# Slot states (``sst``), as the reference's: 0 empty, 1 placed awaiting
# prefill, 2 ongoing, 3 KV-preempted (parked in its lane), 4 popped for
# resume (within one iteration of a lane's advance), 5 finished, not yet
# drained by the host. Row order is carried by three per-slot counters:
# ``rnsq`` (global placement sequence: the new batch's order), ``rjsq`` (the
# lane's join sequence: the ongoing list's order, which breaks ties between
# eviction victims) and ``rpsq`` (the lane's preemption sequence: FIFO
# resume order).

BIG = 1 << 50                   # "never" for lane ranks and empty_at
F_SCALARS = ("t", "theta")
F_LANES = ("t_w", "K1", "C1", "K2", "C2", "C3", "H", "J", "M", "MAXBN",
           "CMAXN")
F_ROWS = ("rtds", "rtf1", "rtpe", "rtfn", "rarr")
I_SCALARS = ("K", "idx", "qlen", "seqc", "seed", "draws", "j", "busy_pk",
             "busy_fin", "ovf")
I_LANES = ("jc", "pc", "MAXB", "mode", "rank", "p2l", "empty_at")
I_ROWS = ("sst", "rid", "rli", "rlr", "rlo", "rnsq", "rjsq", "rpsq")
SCALARS = frozenset(F_SCALARS + I_SCALARS)
# ``ovf`` bits: a placement found its lane's slots full (the host grows the
# rows and runs the chunk again), the queue was presized too small
OVF_SLOTS, OVF_QUEUE = 1, 2
_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def chunk_layout(W: int, B: int, Q: int):
    """The packed state's layout for ``W`` lanes of ``B`` slots and a queue
    of ``Q``: ``(nf, ni, fields)``, where ``fields[name]`` is ``(buffer,
    offset, size)`` with ``buffer`` 0 for the float64 buffer of ``nf``
    values and 1 for the int64 buffer of ``ni``. Scalars come first, then
    the per-lane arrays (``W`` each), the per-slot rows (``W * B`` each,
    lane-major) and, last in the int64 buffer, the queue ``q``. The kernel
    computes the same offsets (``chunk.cu``, ``Layout``)."""
    fields = {}
    for buf, groups in ((0, ((F_SCALARS, 1), (F_LANES, W),
                             (F_ROWS, W * B))),
                        (1, ((I_SCALARS, 1), (I_LANES, W),
                             (I_ROWS, W * B), (("q",), Q)))):
        off = 0
        for names, size in groups:
            for name in names:
                fields[name] = (buf, off, size)
                off += size
        if buf == 0:
            nf = off
        else:
            ni = off
    return nf, ni, fields


def _mix64(z: int) -> int:
    """splitmix64's finalizer on a 64-bit unsigned integer."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def po2_draw(seed: int, counter: int) -> int:
    """The ``counter``-th 64-bit draw of po2's counter-based generator keyed
    on ``seed`` (splitmix64 over the key's mix plus the counter times the
    golden ratio); ``chunk.cu`` computes the same bits."""
    return _mix64((_mix64(seed & _MASK64) + (counter + 1) * _GOLDEN)
                  & _MASK64)


def pack_state(vals: dict, W: int, B: int, Q: int):
    """The packed state (``chunk_layout(W, B, Q)``) as two numpy buffers,
    float64 and int64, from ``vals``: a value or an array for each field
    (rows as (W, B) or flat, lane-major; a shorter ``q`` is padded with
    zeros)."""
    nf, ni, fields = chunk_layout(W, B, Q)
    f = np.zeros(nf)
    i = np.zeros(ni, np.int64)
    for name, (buf, off, size) in fields.items():
        v = np.ravel(vals[name])
        (f if buf == 0 else i)[off:off + v.size] = v
    return f, i


def unpack_state(f: np.ndarray, i: np.ndarray, W: int, B: int,
                 Q: int) -> dict:
    """``pack_state``'s inverse: each field of the buffers, a scalar or a
    flat view."""
    _nf, _ni, fields = chunk_layout(W, B, Q)
    out = {}
    for name, (buf, off, size) in fields.items():
        v = (f if buf == 0 else i)[off:off + size]
        out[name] = v[0] if name in SCALARS else v
    return out


def _chunk(st: dict, trace, sinks, *, W, B, Q, hb, gamma, ttft, atgt,
           policy, edf, tagged):
    """One candidate's chunk on the unpacked state (Python scalars and
    lists, mutated)."""
    f = i = st
    q = st["q"]
    arr, l_in, l_real, rank_r, ttft_r, atgt_r = trace
    s_lo, s_tds, s_tf1, s_tpe = sinks
    n = len(arr)
    is_al, is_jsq = policy == "aladdin", policy == "jsq"
    tag_a = tagged and is_al
    theta = f["theta"]
    K1, C1, K2, C2, C3, H, J, M, MAXBN, CMAXN = (f[k] for k in F_LANES[1:])
    jc, pc, MAXB, mode, rank, p2l, empty_at = (i[k] for k in I_LANES)
    rtds, rtf1, rtpe, rtfn, rarr = (f[k] for k in F_ROWS)
    sst, rid, rli, rlr, rlo, rnsq, rjsq, rpsq = (i[k] for k in I_ROWS)
    sc = i                              # the int scalars, updated in place
    online = [w for w in range(W) if mode[w] == 2]
    nserv = len(online)

    def kv_peak(w, rem_c, ctx_c):
        """Constraint (e): the peak KV demand of lane ``w``'s members plus
        the candidate, for every future step count at which one of them
        ends (``kv_peak_arrays``)."""
        rems, ctxs = [rem_c], [ctx_c]
        for s in range(w * B, w * B + B):
            if sst[s] == 1 or sst[s] == 2:
                rems.append(max(rlr[s] - rlo[s], 0))
                ctxs.append(rli[s] + rlo[s])
        h, jv = H[w], J[w]
        peak = h * sum(ctxs) + jv * len(rems)
        for k in {max(x, 1) for x in rems}:
            cnt = sum(1 for x in rems if x >= k)
            if cnt:
                tot = h * (sum(c for x, c in zip(rems, ctxs) if x >= k)
                           + cnt * k) + jv * cnt
                if tot > peak:
                    peak = tot
        return peak

    def place_pass():
        cnt, newsum, newctx, ctx0 = {}, {}, {}, {}
        wctx, dbud, dbud_t, amin, tmin = {}, {}, {}, {}, {}
        for w in online:
            c = ns = nc = c0 = 0
            slack = slack_t = am = tm = _INF
            # the weighted context in the numpy core's order: the ongoing
            # rows by join sequence, then the new batch by placement
            # sequence (a float sum, so the order shows in the last ulp)
            lane = range(w * B, w * B + B)
            wc = 0.0
            for s in (sorted((s for s in lane if sst[s] == 2),
                             key=rjsq.__getitem__)
                      + sorted((s for s in lane if sst[s] == 1),
                               key=rnsq.__getitem__)):
                wc += rli[s] + gamma * rlr[s]
            for s in lane:
                st = sst[s]
                if st != 1 and st != 2:
                    continue
                c += 1
                if tag_a:
                    am = min(am, atgt_r[rid[s]])
                if st == 1:
                    ns += rli[s]
                    nc += rli[s] + rlo[s]
                    if tag_a:
                        tm = min(tm, ttft_r[rid[s]])
                    continue
                c0 += rli[s] + rlo[s]
                if is_al:
                    m_ = rlo[s] - 1 if rlo[s] > 1 else 0
                    slack = min(slack, atgt * m_ - rtds[s])
                    if tag_a:
                        a_ = atgt_r[rid[s]]
                        a_ = atgt if math.isinf(a_) else a_
                        slack_t = min(slack_t, a_ * m_ - rtds[s])
            cnt[w], newsum[w], newctx[w], ctx0[w], wctx[w] = c, ns, nc, c0, wc
            dbud[w] = theta * max(slack, 0.0) if is_al else 0.0
            dbud_t[w] = theta * max(slack_t, 0.0) if is_al else 0.0
            amin[w], tmin[w] = am, tm
        keep = 0
        for qi in range(sc["qlen"]):
            r = q[qi]
            liv, lrv, lov = l_in[r], l_real[r], s_lo[r]
            v = liv + gamma * lrv
            w = -1
            if is_al:
                ar, tr = atgt_r[r], ttft_r[r]
                ct = tag_a and math.isfinite(ar)
                walk = []
                for x in online:
                    bpost = cnt[x] + 1
                    if ct:     # an untagged candidate takes the scalar branch
                        a0 = min(amin[x], ar)
                        a_eff = atgt if math.isinf(a0) else a0
                        t0 = min(tmin[x], tr)
                        t_eff = ttft if math.isinf(t0) else t0
                        d_eff = dbud_t[x]
                    else:
                        a_eff, t_eff, d_eff = atgt, ttft, dbud[x]
                    budget = (max(((a_eff - C3[x]) - C2[x] * bpost) / K2[x],
                                  0.0) if K2[x] > 0 else _INF)
                    pre_t = K1[x] * (newsum[x] + liv) + C1[x]
                    if (bpost <= MAXB[x] and wctx[x] + v <= theta * budget
                            and pre_t <= t_eff and pre_t <= d_eff):
                        # lazy best fit: capacity norm descending, ties in
                        # serving order
                        walk.append((-math.hypot(cnt[x] / MAXBN[x],
                                                 wctx[x] / CMAXN[x]),
                                     rank[x], x))
                walk.sort()
                rem_c, ctx_c = max(lrv - lov, 0), liv + lov
                for _, _, x in walk:
                    if kv_peak(x, rem_c, ctx_c) <= theta * M[x]:
                        w = x
                        break
            else:
                # kv_now admission (_admit_naive), shared by jsq and po2
                admit = {x for x in online
                         if ((H[x] * (ctx0[x] + newctx[x]) + J[x] * cnt[x])
                             + (H[x] * liv + J[x])) <= M[x]
                         and cnt[x] + 1 <= MAXB[x]}
                if is_jsq:      # the smallest batch, ties in serving order
                    if admit:
                        w = min(admit, key=lambda x: (cnt[x], rank[x]))
                else:
                    cands = []
                    if nserv >= 2:
                        u1 = po2_draw(sc["seed"], sc["draws"])
                        u2 = po2_draw(sc["seed"], sc["draws"] + 1)
                        sc["draws"] += 2
                        r1 = u1 % nserv
                        r2 = u2 % (nserv - 1)
                        cands = [p2l[r1], p2l[r2 + (r2 >= r1)]]
                        if wctx[cands[1]] < wctx[cands[0]]:
                            cands.reverse()
                    elif nserv == 1:
                        cands = [p2l[0]]
                    w = next((x for x in cands if x in admit), -1)
                    if w < 0:   # the least weighted context, ties in order
                        rest = [x for x in admit if x not in cands]
                        if rest:
                            w = min(rest, key=lambda x: (wctx[x], rank[x]))
            slot = -1
            if w >= 0:
                try:
                    slot = sst.index(0, w * B, w * B + B)
                except ValueError:
                    sc["ovf"] |= OVF_SLOTS
            if slot < 0:
                q[keep] = r             # stays queued, FIFO order kept
                keep += 1
                continue
            sst[slot], rid[slot] = 1, r
            rli[slot], rlr[slot], rlo[slot] = liv, lrv, lov
            rtds[slot], rtf1[slot], rtpe[slot] = s_tds[r], s_tf1[r], s_tpe[r]
            rtfn[slot], rarr[slot] = _NAN, arr[r]
            rnsq[slot], rjsq[slot], rpsq[slot] = sc["seqc"], 0, 0
            sc["seqc"] += 1
            cnt[w] += 1
            newsum[w] += liv
            newctx[w] += liv + lov
            wctx[w] += v
            if tag_a:
                amin[w] = min(amin[w], atgt_r[r])
                tmin[w] = min(tmin[w], ttft_r[r])
        sc["qlen"] = keep

    def advance(w, t, t_start, t_end):
        """Lane ``w``'s ``advance_to(t_end)`` from its clock ``t``, with the
        KV semantics of the numpy core's ``_Engine._advance``; returns the
        lane's new clock."""
        lane = range(w * B, w * B + B)
        k1, c1, k2, c2, c3 = K1[w], C1[w], K2[w], C2[w], C3[w]
        h, jv, Mw = H[w], J[w], M[w]
        # a lane that sat booting or idle starts its pending work at the
        # beat start
        if t < t_start and t < t_end and any(sst[s] == 1 or sst[s] == 3
                                             for s in lane):
            t = t_start
        thr = 0.9 * Mw
        while t < t_end:
            on = [s for s in lane if sst[s] == 2]
            C = sum(rli[s] + rlo[s] for s in on)
            base = h * C + jv * len(on)
            # FIFO head-blocking resume, each pop tested against the
            # occupancy before the pops
            pre = sorted((s for s in lane if sst[s] == 3),
                         key=rpsq.__getitem__)
            res = []
            for s in pre:
                if not base + h * (rli[s] + rlo[s]) + jv <= thr:
                    break
                res.append(s)
            new = sorted((s for s in lane if sst[s] == 1),
                         key=rnsq.__getitem__)
            if new or res:
                # joint prefill of the new batch and the resumed victims;
                # everyone else stalls through it
                tot = sum(rli[s] + rlo[s] for s in new + res)
                dur = k1 * tot + c1
                t_pre = t + dur
                for s in on + pre:
                    rtds[s] += dur
                for s in new:
                    if math.isnan(rtf1[s]):
                        rtf1[s], rlo[s] = t_pre, 1
                    elif not math.isnan(rtpe[s]):
                        # a KV-loss re-entrant: the stall since the reclaim
                        rtds[s] += max(t_pre - rtpe[s], 0.0)
                    rtpe[s] = _NAN
                for k, s in enumerate(new + res):
                    rjsq[s], sst[s] = jc[w] + k, 2
                jc[w] += len(new) + len(res)
                t = t_pre
                continue
            if not on:
                t = t_end
                break
            # KV overflow: evict the youngest arrival, ties to the earliest
            # joiner
            b = len(on)
            while h * C + jv * b > Mw and b > 1:
                vic = max(on, key=lambda s: (rarr[s], -rjsq[s]))
                on.remove(vic)
                sst[vic], rpsq[vic] = 3, pc[w]
                pc[w] += 1
                C -= rli[vic] + rlo[vic]
                b -= 1
            # a decode segment: the batch is fixed until a finish, a KV
            # overflow or the beat end
            n_fin = min(max(rlr[s] - rlo[s], 1) for s in on)
            cb = c2 * b
            k, td, seg = 0, t, 0.0
            while k < n_fin and td < t_end:
                ck = C + k * b
                if k > 0 and h * ck + jv * b > Mw and b > 1:
                    break
                dur = k2 * ck + cb + c3
                k += 1
                td += dur
                seg += dur
            for s in on:
                rlo[s] += k
                rtds[s] += seg
                if rlo[s] >= rlr[s]:
                    rtfn[s], sst[s] = td, 5
            for s in lane:
                if sst[s] == 3:         # preempted clocks stall too
                    rtds[s] += seg
            t = td
        return t

    def occupied() -> bool:
        return any(0 < x < 5 for x in sst)

    t = f["t"]
    while sc["j"] < sc["K"] and not (sc["idx"] >= n and sc["qlen"] == 0
                                     and not occupied()):
        while sc["idx"] < n and arr[sc["idx"]] <= t:
            if sc["qlen"] >= Q:
                sc["ovf"] |= OVF_QUEUE
                break
            q[sc["qlen"]] = sc["idx"]
            sc["qlen"] += 1
            sc["idx"] += 1
        if edf:         # priority, then deadline: the host's total rank
            q[:sc["qlen"]] = sorted(q[:sc["qlen"]], key=rank_r.__getitem__)
        if sc["qlen"]:
            place_pass()
        t_next = t + hb
        # the serving and draining lanes advance; as the jit core's vmap,
        # the beat returns every lane's clock
        f["t_w"] = [advance(w, tw, t, t_next)
                    if mode[w] == 2 or mode[w] == 3 else tw
                    for w, tw in enumerate(f["t_w"])]
        # the host's billing replay: online lanes busy with ongoing or new
        # rows, and the first beat at which a draining lane held nothing
        busy = 0
        for w in range(W):
            lane = sst[w * B:w * B + B]
            if mode[w] == 2 and any(x == 1 or x == 2 for x in lane):
                busy += 1
            if mode[w] == 3 and empty_at[w] == BIG \
                    and not any(0 < x < 5 for x in lane):
                empty_at[w] = sc["j"]
        sc["busy_pk"] = max(sc["busy_pk"], busy)
        sc["busy_fin"] = busy
        sc["j"] += 1
        t = t_next
    f["t"] = t


def chunk_plain(fstate: torch.Tensor, istate: torch.Tensor,
                arrival: torch.Tensor, l_in: torch.Tensor,
                l_real: torch.Tensor, rank_r: torch.Tensor,
                ttft_r: torch.Tensor, atgt_r: torch.Tensor,
                s_lo: torch.Tensor, s_f: torch.Tensor, *, W: int, B: int,
                Q: int, hb: float, gamma: float, ttft: float, atgt: float,
                policy: str, edf: bool = False,
                tagged: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``chunk``, candidate after candidate.

    fstate (C, nf) float64 and istate (C, ni) int64: each candidate's
    packed state (``chunk_layout(W, B, Q)``), read only; its int scalar
    ``K`` is the number of beats to advance (0: the candidate rides along).
    arrival (n,) float64, sorted; l_in, l_real, rank_r (n,) int64; ttft_r,
    atgt_r (n,) float64 (``inf`` = untagged); s_lo (C, n) int64 and s_f
    (C, 3, n) float64 (t_decode_spent, first-token time, preemption time):
    the re-entrant sinks from which a requeued request resumes. ``hb`` is
    the heartbeat, ``gamma`` and the SLO targets ``ttft``/``atgt`` those of
    the scenario, ``policy`` one of aladdin, jsq, po2 (constraint (e)'s KV
    peak, or the kv_now admission); ``edf`` sorts the backlog by
    ``rank_r`` every beat, ``tagged`` (with aladdin) budgets constraints
    (b)-(d) against per-request SLOs.

    Returns the advanced (fstate, istate): the beats run in scalar ``j``,
    stopping after ``K`` or when drained."""
    _chunk_check(fstate, istate, W, B, Q, policy)
    trace = [x.tolist() for x in (arrival, l_in, l_real, rank_r, ttft_r,
                                  atgt_r)]
    kw = dict(W=W, B=B, Q=Q, hb=float(hb), gamma=float(gamma),
              ttft=float(ttft), atgt=float(atgt), policy=policy,
              edf=bool(edf), tagged=bool(tagged))
    fo, io = [], []
    for c in range(fstate.shape[0]):
        st = {k: v.tolist() for k, v in unpack_state(
            fstate[c].numpy(), istate[c].numpy(), W, B, Q).items()}
        sinks = [s_lo[c].tolist()] + [x.tolist() for x in s_f[c]]
        _chunk(st, trace, sinks, **kw)
        fs, is_ = pack_state(st, W, B, Q)
        fo.append(fs)
        io.append(is_)
    return (torch.from_numpy(np.stack(fo)).to(fstate.device),
            torch.from_numpy(np.stack(io)).to(fstate.device))


_POLICY_CODES = {"aladdin": 0, "jsq": 1, "po2": 2}


def _chunk_check(fstate, istate, W, B, Q, policy):
    """Check the packed state's shape against the layout; return it."""
    if policy not in _POLICY_CODES:
        raise ValueError(f"chunk: policy {policy!r} not in "
                         f"{tuple(_POLICY_CODES)}")
    if W < 1 or B < 1 or Q < 1:
        raise ValueError(f"chunk: W, B and Q must be >= 1, got {W}, {B}, "
                         f"{Q}")
    nf, ni, fields = chunk_layout(W, B, Q)
    C = fstate.shape[0] if fstate.dim() == 2 else -1
    if fstate.dim() != 2 or fstate.shape != (C, nf) \
            or istate.shape != (C, ni) or C < 1 \
            or fstate.dtype != torch.float64 or istate.dtype != torch.int64:
        raise ValueError(f"chunk: the state must be (C, {nf}) float64 and "
                         f"(C, {ni}) int64 for W={W}, B={B}, Q={Q}; got "
                         f"{tuple(fstate.shape)} {fstate.dtype} and "
                         f"{tuple(istate.shape)} {istate.dtype}")
    return nf, ni, fields


# The kernel's optional counters, one row of int64 per candidate (``chunk``'s
# ``stats``): SM cycles on the CTA's thread 0 for the whole launch and for
# each phase of a beat (admission and the EDF sort, the lanes' aggregates,
# the placement pass, the lanes' advance, the billing replay, the occupancy
# test); beats; queued requests the placement pass tried; requests placed;
# constraint (e) tests, one for each lane that passed constraints (a)-(d)
# for an aladdin request; the members of the tested lanes, summed and at
# most; the placement pass's own split: cycles of its tries' rounds over
# the lanes (staging the queue included), of the choices and commits, and
# the tries that found a lane; and the tries that a request which found no
# lane earlier in the pass settled without a round.
STATS = ("cycles", "admit_cycles", "aggregate_cycles", "place_cycles",
         "advance_cycles", "billing_cycles", "occupancy_cycles", "beats",
         "tried", "placed", "e_tests", "members", "members_max",
         "try_cycles", "commit_cycles", "any_lane", "dominated")


def chunk_scratch_bytes(W: int, B: int) -> int:
    """The global scratch a kernel launch needs for each candidate's member
    lists (chunk.cu's ``member_bytes``), or 0 where they fit in shared
    memory beside the lanes. It asks the built library, so it needs the
    card."""
    return int(_build.module().fastsim_chunk_scratch(W, B))


def chunk(fstate: torch.Tensor, istate: torch.Tensor, arrival: torch.Tensor,
          l_in: torch.Tensor, l_real: torch.Tensor, rank_r: torch.Tensor,
          ttft_r: torch.Tensor, atgt_r: torch.Tensor, s_lo: torch.Tensor,
          s_f: torch.Tensor, *, W: int, B: int, Q: int, hb: float,
          gamma: float, ttft: float, atgt: float, policy: str,
          edf: bool = False, tagged: bool = False,
          stats: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See ``chunk_plain``. On CUDA: one launch for all candidates, which
    writes new state tensors and leaves its inputs as they were, so the
    host can run the same chunk again from the same state. ``stats``, a
    (C, len(STATS)) int64 tensor on the card, receives the kernel's
    counters (``STATS``): the launch adds to it (``members_max`` keeps the
    larger), so one tensor can gather a run. The plain version has none."""
    kw = dict(W=W, B=B, Q=Q, hb=hb, gamma=gamma, ttft=ttft, atgt=atgt,
              policy=policy, edf=edf, tagged=tagged)
    args = (fstate, istate, arrival, l_in, l_real, rank_r, ttft_r, atgt_r,
            s_lo, s_f)
    if not fstate.is_cuda:
        if fstate.device.type == "cpu" and stats is None:
            return chunk_plain(*args, **kw)
        raise ValueError(f"chunk: unsupported device {fstate.device}, or "
                         "stats without the kernel")
    _chunk_check(fstate, istate, W, B, Q, policy)
    C = int(fstate.shape[0])
    n = int(arrival.shape[0])
    want = ((arrival, torch.float64, (n,)), (l_in, torch.int64, (n,)),
            (l_real, torch.int64, (n,)), (rank_r, torch.int64, (n,)),
            (ttft_r, torch.float64, (n,)), (atgt_r, torch.float64, (n,)),
            (s_lo, torch.int64, (C, n)), (s_f, torch.float64, (C, 3, n)),
            (fstate, torch.float64, tuple(fstate.shape)),
            (istate, torch.int64, tuple(istate.shape)))
    if stats is not None:
        want += ((stats, torch.int64, (C, len(STATS))),)
    for x, dt, shape in want:
        if x.dtype != dt or tuple(x.shape) != shape \
                or x.device != fstate.device or not x.is_contiguous():
            raise ValueError(f"chunk: expected a contiguous {shape} {dt} "
                             f"tensor on {fstate.device}; got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"chunk: {n} requests; the kernel takes 1 to "
                         "2**31 - 1")
    fout = torch.empty_like(fstate)
    iout = torch.empty_like(istate)
    nbytes = chunk_scratch_bytes(W, B)
    scratch = torch.empty((C, nbytes), dtype=torch.uint8,
                          device=fstate.device) if nbytes else None
    _build.module().fastsim_chunk(
        arrival.data_ptr(), l_in.data_ptr(), l_real.data_ptr(),
        rank_r.data_ptr(), ttft_r.data_ptr(), atgt_r.data_ptr(),
        s_lo.data_ptr(), s_f.data_ptr(), fstate.data_ptr(),
        istate.data_ptr(), fout.data_ptr(), iout.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if stats is None else stats.data_ptr(),
        n, W, B, Q, C,
        float(hb), float(gamma), float(ttft), float(atgt),
        _POLICY_CODES[policy], bool(edf), bool(tagged),
        torch._C._cuda_getCurrentRawStream(fstate.get_device()))
    chunk.launches += 1
    return fout, iout


chunk.launches = 0

__all__ = ["BIG", "OVF_QUEUE", "OVF_SLOTS", "SCALARS", "STATS",
           "WHOLE_STATS", "chunk", "chunk_layout", "chunk_plain",
           "chunk_scratch_bytes", "pack_state", "po2_draw", "unpack_state",
           "whole_trace", "whole_trace_plain", "whole_trace_scratch_bytes"]
