"""SLO-aware request placement (paper §4.2).

The MIP's constraints, evaluated per worker:

  (b) decode-latency budget:  Σ_j (l_in_j + γ·l_pred_j)  ≤  θ · C_max(b)
      with C_max from Eq. 4 and b the post-placement batch size;
  (c) TTFT budget:            t_pre(Σ new l_in)          ≤  T_pre;
  (d) preemption budget:      t_pre(Σ new l_in)          ≤  θ · min_j slack_j,
      slack_j = T_dec·(l_out_j − 1) − t_dec_j (decode time the ongoing
      requests have "banked" against the ATGT SLO; ATGT divides by
      l_out − 1, the first token being TTFT's);
  (e) per-iteration KV:       peak over future iterations of Σ kv_j(·) ≤ M.

Algorithm 1 (best-fit): rank workers by capacity_norm (L2 norm of batch size
and weighted context) descending, place on the first feasible one, else open
a new worker. ``exact_min_workers`` (core/mip.py) is the brute-force
reference used in tests to certify near-optimality.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO


@dataclasses.dataclass
class PlacementConfig:
    gamma: float = 0.5      # strictness knob γ in (b): weight on l_pred
    theta: float = 0.9      # prediction-error head-room θ in (b)/(d)
    kv_capacity: float = 0.0          # M, bytes per worker
    max_batch: int = 512              # engine hard cap on batch slots
    split_phase: bool = False         # decode-pool worker: no prefill runs
                                      # here, so (c)/(d) do not apply


class WorkerState:
    """Scheduler-side view of one serving worker.

    ``cfg`` and ``perf`` are per-worker: a heterogeneous fleet mixes workers
    whose KV capacity, batch cap and latency models differ (e.g. A100 TP=4
    next to V100 TP=8 — each built from its own Eq. 5-6 search)."""

    def __init__(self, wid: int, cfg: PlacementConfig, perf: PerfModel,
                 slo: SLO):
        self.id = wid
        self.cfg = cfg
        self.perf = perf
        self.slo = slo
        self.ongoing: List[Request] = []    # decoding (or placed) requests
        self.new_batch: List[Request] = []  # placed this heartbeat, not begun
        self.alive = True
        self.draining = False               # straggler mitigation
        # cached Σ (l_in + γ·l_pred) over ongoing+new_batch; validated against
        # the list lengths so external list mutation forces a recompute, and
        # updated incrementally by place/unplace (which keep lengths AND the
        # sum in sync even when a re-balance move leaves lengths unchanged
        # on net). l_pred re-predictions must call mark_dirty().
        self._wctx = 0.0
        self._wctx_key: Optional[tuple] = None

    # ---- aggregate views ----------------------------------------------------
    @property
    def batch_size(self) -> int:
        return len(self.ongoing) + len(self.new_batch)

    def mark_dirty(self) -> None:
        """Invalidate cached aggregates after an in-place request mutation
        (e.g. Algorithm 2 re-prediction rewriting l_pred)."""
        self._wctx_key = None

    def _wctx_now(self) -> float:
        key = (len(self.ongoing), len(self.new_batch))
        if self._wctx_key != key:
            g = self.cfg.gamma
            self._wctx = sum(r.l_in + g * r.l_pred
                             for r in self.ongoing + self.new_batch)
            self._wctx_key = key
        return self._wctx

    def weighted_context(self, gamma: Optional[float] = None) -> float:
        if gamma is None or gamma == self.cfg.gamma:
            return self._wctx_now()
        return sum(r.l_in + gamma * r.l_pred
                   for r in self.ongoing + self.new_batch)

    def capacity_norm(self) -> float:
        """L2 norm of (batch size, weighted context) — the worker 'load' used
        to rank bins in Algorithm 1 (normalized so both terms are O(1))."""
        b = self.batch_size / max(self.cfg.max_batch, 1)
        cmax = self.perf.decode.max_total_context(1, self.slo.atgt) or 1.0
        c = self.weighted_context() / max(cmax, 1.0)
        return math.hypot(b, c)

    # ---- constraints ---------------------------------------------------------
    #
    # Multi-tenant traces stamp per-request SLO budgets (Request.slo_ttft /
    # slo_atgt); constraints (b)-(d) then budget each decision against the
    # strictest budget among the requests it actually affects. Untagged
    # requests carry ``inf`` budgets and every path below short-circuits to
    # the scalar ``self.slo`` arithmetic — the legacy float image is
    # untouched (and for a single tenant the tagged budgets *equal* the
    # planning SLO, so the comparisons see identical floats either way).

    def _tagged(self, reqs: Sequence[Request]) -> bool:
        return any(r.slo_atgt != math.inf for r in reqs)

    def _constraint_b(self, reqs: Sequence[Request]) -> bool:
        b = self.batch_size + len(reqs)
        if b > self.cfg.max_batch:
            return False
        if self._tagged(reqs):
            # Eq. 4's budget holds for the whole batch at the strictest
            # member ATGT: min over ongoing + new batch + candidates
            atgt = min(min((r.slo_atgt for r in reqs)),
                       min((m.slo_atgt for m in
                            self.ongoing + self.new_batch),
                           default=math.inf))
            if atgt == math.inf:
                atgt = self.slo.atgt
        else:
            atgt = self.slo.atgt
        budget = self.perf.decode.max_total_context(b, atgt)
        w = self.weighted_context() + sum(
            r.l_in + self.cfg.gamma * r.l_pred for r in reqs)
        return w <= self.cfg.theta * budget

    def _prefill_time(self, total_new: float) -> float:
        p = self.perf.prefill
        return p.k1 * total_new + p.c1   # scalar Eq. 2 (hot path: no numpy)

    def _constraint_c(self, reqs: Sequence[Request]) -> bool:
        # a prefix-cache hit (cached_len > 0, granted on THIS worker) only
        # prefills the new tokens — the TTFT/preemption budgets price that
        # shorter prefill. cached_len == 0 (every single-shot request)
        # leaves the integer sum, and hence the float image, untouched.
        total_new = sum(r.l_in - r.cached_len for r in self.new_batch) + \
            sum(r.l_in - r.cached_len for r in reqs)
        if self._tagged(reqs):
            # the joint prefill delays every new-batch member, so it must
            # fit the tightest TTFT budget among them and the candidates
            ttft = min(min((r.slo_ttft for r in reqs)),
                       min((m.slo_ttft for m in self.new_batch),
                           default=math.inf))
            if ttft == math.inf:
                ttft = self.slo.ttft
        else:
            ttft = self.slo.ttft
        return self._prefill_time(total_new) <= ttft

    def _constraint_d(self, reqs: Sequence[Request]) -> bool:
        if not self.ongoing:
            return True
        # ATGT divides decode time by (l_out - 1) — the first token is paid
        # by TTFT — so the banked slack is atgt*(l_out - 1), not atgt*l_out:
        # budgeting against l_out lets every stalled request finish up to
        # l_real/(l_real-1) over the SLO (a scale-invariant miss tail)
        if self._tagged(reqs):
            slack = min((self.slo.atgt if m.slo_atgt == math.inf
                         else m.slo_atgt) * max(m.l_out - 1, 0)
                        - m.t_decode_spent for m in self.ongoing)
        else:
            slack = min(self.slo.atgt * max(r.l_out - 1, 0)
                        - r.t_decode_spent for r in self.ongoing)
        total_new = sum(r.l_in - r.cached_len for r in self.new_batch) + \
            sum(r.l_in - r.cached_len for r in reqs)
        return self._prefill_time(total_new) <= \
            self.cfg.theta * max(slack, 0.0)

    def kv_peak(self, extra: Sequence[Request] = ()) -> float:
        """Constraint (e): peak KV demand over future iterations.

        Each request j contributes kv(context_j + k) at future iteration k and
        drops to zero after remaining_pred_j steps; the total is piecewise
        monotone between finish events, so the peak is attained just before
        some request finishes (or at k=0 when over-capacity already). The KV
        model is linear (Eq. 1), so each candidate peak is h·Σcontext_alive
        + n_alive·(h·k + j) over the suffix of requests outliving step k —
        O(b log b) overall instead of O(b²) kv-model evaluations."""
        reqs = list(self.ongoing) + self.new_batch + list(extra)
        if not reqs:
            return 0.0
        h, j = self.perf.kv.h, self.perf.kv.j
        items = sorted((r.remaining_pred, r.context) for r in reqs)
        n = len(items)
        suffix_ctx = 0.0
        suffix = [0.0] * (n + 1)       # suffix[i] = Σ context of items[i:]
        for i in range(n - 1, -1, -1):
            suffix_ctx += items[i][1]
            suffix[i] = suffix_ctx
        peak = h * suffix[0] + j * n
        i = 0
        for k in sorted({max(rem, 1) for rem, _ in items}):
            while i < n and items[i][0] < k:
                i += 1                 # drop requests finished before step k
            if i == n:
                break
            tot = h * (suffix[i] + (n - i) * k) + j * (n - i)
            if tot > peak:
                peak = tot
        return peak

    def _constraint_e(self, reqs: Sequence[Request]) -> bool:
        # theta pads the *predicted* KV trajectory against underestimates
        # (the w vectors in (e) are built from l_pred, so they carry the
        # same prediction error theta exists to absorb).
        return self.kv_peak(reqs) <= self.cfg.theta * self.cfg.kv_capacity

    def kv_now(self, extra: Sequence[Request] = ()) -> float:
        """Current KV usage (what a vLLM-style admission check sees)."""
        h, j = self.perf.kv.h, self.perf.kv.j
        own = len(self.ongoing) + len(self.new_batch)
        return h * sum(r.context for r in self.ongoing + self.new_batch) \
            + j * own + sum(h * r.l_in + j for r in extra)

    def _admit_naive(self, reqs: Sequence[Request]) -> bool:
        """Baseline admission: current KV + the new prompts fit, batch slot
        free. No future-peak, no latency awareness."""
        return (self.kv_now(reqs) <= self.cfg.kv_capacity
                and self.batch_size + len(reqs) <= self.cfg.max_batch)

    def feasible(self, reqs: Sequence[Request]) -> bool:
        if not self.alive or self.draining:
            return False
        if self.cfg.split_phase:
            return self._constraint_b(reqs) and self._constraint_e(reqs)
        return (self._constraint_b(reqs) and self._constraint_c(reqs)
                and self._constraint_d(reqs) and self._constraint_e(reqs))

    # ---- mutation ------------------------------------------------------------
    def place(self, r: Request) -> None:
        self._wctx_now()
        r.worker = self.id
        self.new_batch.append(r)
        self._wctx += r.l_in + self.cfg.gamma * r.l_pred
        self._wctx_key = (len(self.ongoing), len(self.new_batch))

    def unplace(self, r: Request) -> None:
        self._wctx_now()
        self.new_batch.remove(r)
        r.worker = None
        r.cached_len = 0    # a prefix-cache grant is void off this worker
        self._wctx -= r.l_in + self.cfg.gamma * r.l_pred
        self._wctx_key = (len(self.ongoing), len(self.new_batch))


# ---- vectorized scoring (struct-of-arrays engine) ----------------------------
#
# Array twins of the per-worker constraint/scoring methods above, shared by
# ``serving.fastsim``. They replicate the scalar code's floating-point
# operation ORDER exactly (multiply-then-add chains, sequential suffix
# accumulation), so a placement decision computed on arrays is bit-for-bit
# the decision the WorkerState methods would have made.


def kv_peak_arrays(rem: np.ndarray, ctx: np.ndarray, h: float,
                   j: float) -> float:
    """Vectorized :meth:`WorkerState.kv_peak`: peak future KV demand of a
    batch described by int arrays ``rem`` (remaining predicted tokens) and
    ``ctx`` (current context) — identical value to the scalar suffix scan."""
    n = int(rem.shape[0])
    if n == 0:
        return 0.0
    order = np.lexsort((ctx, rem))          # == sorted((rem, ctx)) tuples
    rem_s = rem[order]
    ctx_s = ctx[order]
    # suffix[i] = Σ ctx_s[i:], accumulated high-index-first like the scalar
    # loop (integer-valued, so the float image is exact either way)
    suffix = np.cumsum(ctx_s[::-1])[::-1]
    peak = h * float(suffix[0]) + j * n
    ks = np.unique(np.maximum(rem_s, 1))
    i = np.searchsorted(rem_s, ks, side="left")
    valid = i < n
    if valid.any():
        iv = i[valid]
        kv = ks[valid]
        tot = h * (suffix[iv] + (n - iv) * kv) + j * (n - iv)
        m = float(tot.max())
        if m > peak:
            peak = m
    return peak


def decode_budget_arrays(batch: np.ndarray, atgt, k2: np.ndarray,
                         c2: np.ndarray, c3: np.ndarray) -> np.ndarray:
    """Vectorized Eq. 4 across workers: ``max_total_context(batch, atgt)``
    per worker (inf where k2 <= 0), matching the scalar op order
    ``((atgt - c3) - c2*b) / k2`` then ``max(. , 0.0)``. ``atgt`` is a
    scalar, or a per-worker vector of effective (strictest-member) ATGT
    budgets in multi-tenant runs."""
    out = np.full(batch.shape, np.inf)
    pos = k2 > 0
    if pos.any():
        a = atgt[pos] if np.ndim(atgt) else atgt
        out[pos] = np.maximum(
            (a - c3[pos] - c2[pos] * batch[pos]) / k2[pos], 0.0)
    return out


def slack_arrays(l_out: np.ndarray, tds: np.ndarray, mask: np.ndarray,
                 atgt) -> np.ndarray:
    """Vectorized constraint-(d) banked slack: per-worker min over ongoing
    members of ``atgt*max(l_out-1, 0) - t_decode_spent`` for a padded
    (W, B) member layout; +inf where a worker has no ongoing requests.
    ``atgt`` is a scalar, or a (W, B) per-member budget array in
    multi-tenant runs (broadcast leaves the scalar image unchanged)."""
    vals = atgt * np.maximum(l_out - 1, 0) - tds
    vals = np.where(mask, vals, np.inf)
    return vals.min(axis=1)


def best_fit_order(norms: np.ndarray) -> np.ndarray:
    """Algorithm 1's ranking: capacity_norm descending, ties in worker-list
    order (``sorted(..., reverse=True)`` never reorders equal keys, and
    neither does a stable argsort of the negated key)."""
    return np.argsort(-norms, kind="stable")


def jsq_order(batch_sizes: np.ndarray) -> np.ndarray:
    """JSQ's ranking: batch size ascending, ties in worker-list order."""
    return np.argsort(batch_sizes, kind="stable")


def best_fit_place(workers: List[WorkerState], req: Request,
                   allow_new: bool = True,
                   new_worker_factory=None) -> Optional[WorkerState]:
    """Algorithm 1. Returns the worker the request was placed on (possibly a
    newly opened one), or None if allow_new=False and nothing fits."""
    ranked = sorted((w for w in workers if w.alive and not w.draining),
                    key=lambda w: w.capacity_norm(), reverse=True)
    for w in ranked:
        if w.feasible([req]):
            w.place(req)
            return w
    if allow_new and new_worker_factory is not None:
        w = new_worker_factory()
        workers.append(w)
        w.place(req)
        return w
    return None


def jsq_place(workers: List[WorkerState], req: Request, allow_new=True,
              new_worker_factory=None) -> Optional[WorkerState]:
    """Baseline: join-the-shortest-queue (by batch size), respecting only the
    KV-capacity constraint (what vLLM-style admission does)."""
    live = [w for w in workers if w.alive and not w.draining]
    for w in sorted(live, key=lambda w: w.batch_size):
        if w._admit_naive([req]):
            w.place(req)
            return w
    if allow_new and new_worker_factory is not None:
        w = new_worker_factory()
        workers.append(w)
        w.place(req)
        return w
    return None


def power_of_two_place(workers: List[WorkerState], req: Request, rng,
                       allow_new=True, new_worker_factory=None
                       ) -> Optional[WorkerState]:
    """Baseline: power-of-two-choices by predicted load [paper ref 10]."""
    live = [w for w in workers if w.alive and not w.draining]
    if len(live) >= 2:
        i, j = rng.choice(len(live), size=2, replace=False)
        cands = sorted((live[i], live[j]), key=lambda w: w.weighted_context())
    else:
        cands = live
    for w in cands:
        if w._admit_naive([req]):
            w.place(req)
            return w
    # fall back to any feasible live worker before opening a new one
    for w in sorted(live, key=lambda w: w.weighted_context()):
        if w in cands:
            continue
        if w._admit_naive([req]):
            w.place(req)
            return w
    if allow_new and new_worker_factory is not None:
        w = new_worker_factory()
        workers.append(w)
        w.place(req)
        return w
    return None
