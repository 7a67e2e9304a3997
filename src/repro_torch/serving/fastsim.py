"""Struct-of-arrays colocated simulation core (the ``engine="vectorized"``
path of :mod:`repro.serving.api`).

Per-beat state — the queue, per-worker batch membership, KV occupancy
``h*Σctx + j*b``, decode clocks and the per-request ``l_out`` /
``t_decode_spent`` arrays — lives in numpy arrays; placement scoring and the
decode-segment arithmetic run as array kernels (the scoring twins live in
:mod:`repro.core.placement`). The Python engine
(:func:`repro.serving.simulator.run_heartbeat_loop` over
``ColocatedTopology``) stays the oracle: this engine reproduces its
per-request ``(t_first_token, t_finish, l_out, t_decode_spent)``
**bit-for-bit** (pinned by tests/test_fastsim_equivalence.py), which demands
replicating the reference's floating-point operation order exactly:

* sequential left-associated accumulation (``np.cumsum`` /
  ``np.add.accumulate``) wherever the reference sums in a Python loop —
  never ``np.sum``, whose pairwise reduction rounds differently;
* the worker clock advances through ``np.add.accumulate([t, dur_0, ...])``,
  matching ``t += dur`` per iteration (``t + cumsum(durs)`` does not);
* multiply-add chains keep the scalar code's grouping
  (``k2*C + c2*b + c3`` as ``((k2*C) + (c2*b)) + c3``);
* ``capacity_norm`` keeps CPython's ``math.hypot`` (numpy's may differ in
  the last ulp, which could flip a best-fit ranking);
* integer-valued aggregates (context sums, KV peaks) are exact in float64
  and may be reduced in any order.

Supported envelope (everything else raises ``ValueError`` so ``api.run``
can fall back or the caller can switch engines explicitly): ``Colocated``
topology without ``split_phase``, no length predictor, no observer;
policies ``aladdin`` / ``jsq`` / ``po2``. Fleets may be fixed (explicit
worker count, heterogeneous allowed — every per-worker coefficient is an
array) or policy-scaled (``Reactive`` / ``Forecast`` / ``FeedbackScale`` /
``PolicyScale``): the engine keeps worker state in growable per-lane rows
and plugs them into the REAL :class:`repro.serving.forecast.ManagedPool` /
:class:`repro.serving.lifecycle.WorkerLifecycle` state machines through the
same adapter protocol the reference uses, so every scaling decision (epoch
targets, boots, drains, reclaim victim draws) is made by the reference code
itself on bit-identical inputs. A ``SpotMarket`` is supported on both fixed
and policy-scaled fleets (reclaims share the engine's Generator, which is
consumed in the reference's exact draw order). Elastic fixed fleets
(place-to-open) remain reference-only.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.placement import (best_fit_order, decode_budget_arrays,
                                  jsq_order, kv_peak_arrays, slack_arrays)
from repro_torch.core.request import ReqState, Request
from repro_torch.serving.lifecycle import WorkerLifecycle

DEFAULT_TAIL = 240.0

# above this expected iteration count a decode segment is evaluated as one
# array kernel; below it a scalar loop is cheaper (numpy call overhead)
_SEG_VECTOR_MIN = 16


def check_colocated_envelope(scenario) -> List:
    """Validate that ``scenario`` fits the vectorized engine's envelope and
    return the expanded *initial* per-worker spec list (the t=0 fleet — a
    policy-scaled scenario boots and drains lanes from there). Raises
    ``ValueError`` with the first unsupported feature otherwise."""
    from repro_torch.serving import api

    scenario = api.resolve_scenario(scenario)
    if not isinstance(scenario.topology, api.Colocated):
        raise ValueError("vectorized engine supports Colocated topologies "
                         f"only, not {type(scenario.topology).__name__}")
    topo = scenario.topology
    if topo.split_phase:
        raise ValueError("vectorized engine does not support split_phase "
                         "(decode-pool-only) simulation")
    if topo.policy not in ("aladdin", "jsq", "po2"):
        raise ValueError(f"unknown placement policy {topo.policy!r}")
    if topo.router != "blind":
        raise ValueError("session-affinity routing is reference-engine "
                         f"only (router={topo.router!r}; rerun with "
                         "engine='reference')")
    if topo.prefix_cache not in ("lru", "off"):
        raise ValueError(f"unknown prefix_cache mode {topo.prefix_cache!r}")
    if topo.cache_tokens is not None:
        raise ValueError("per-worker prefix-cache budgets (cache_tokens="
                         f"{topo.cache_tokens!r}) are reference-engine only")
    managed = not isinstance(scenario.scaling, api.FixedScale)
    if managed and not isinstance(
            scenario.scaling, (api.Reactive, api.Forecast, api.FeedbackScale,
                               api.PolicyScale)):
        raise ValueError("unknown scaling declaration "
                         f"{type(scenario.scaling).__name__}")
    market = scenario.market
    if market is not None and (market.prefill_spec is not None
                               or len(market.prefill_events) > 0):
        raise ValueError("SpotMarket.prefill_spec/prefill_events describe "
                         "the prefill side of a Disaggregated topology; a "
                         "Colocated scenario would silently ignore them")
    if scenario.predictor is not None:
        raise ValueError("vectorized engine does not support length "
                         "predictors (l_pred must equal l_real)")
    if scenario.observer is not None:
        raise ValueError("vectorized engine does not support observers "
                         "(there are no per-worker objects to observe)")
    pools = scenario.fleet.for_role("serve")
    if not pools:
        raise ValueError("colocated scenario needs at least one fleet pool")
    if managed:
        scfg = _managed_scfg(scenario)
        specs = [pools[0].spec] * max(scfg.initial_workers, scfg.min_workers)
    elif scenario.scaling.n is not None:
        specs = [pools[0].spec] * int(scenario.scaling.n)
    else:
        specs = [p.spec for p in pools for _ in range(p.count)]
    if not specs:
        raise ValueError("vectorized engine needs an explicit worker count "
                         "(elastic mode needs engine='reference')")
    tenants = scenario.tenants
    if tenants is not None:
        names = []
        for tn in tenants:
            names.append(tn.name)
            if tn.workload is None and scenario.workload is None:
                raise ValueError(f"tenant {tn.name!r} needs a workload")
            if tn.lora is not None:
                raise ValueError(
                    "LoRA adapter residency/swap modeling is reference-"
                    f"engine only (tenant {tn.name!r} sets "
                    f"lora={tn.lora!r})")
            if tn.tier not in ("interactive", "batch"):
                raise ValueError(f"tenant {tn.name!r}: tier must be "
                                 "'interactive' or 'batch', got "
                                 f"{tn.tier!r}")
            if tn.slo.ttft <= 0 or tn.slo.atgt <= 0:
                raise ValueError(f"tenant {tn.name!r}: SLO targets must "
                                 "be positive")
            if tn.attain_target is not None \
                    and not 0.0 < tn.attain_target <= 1.0:
                raise ValueError(f"tenant {tn.name!r}: attain_target "
                                 "must be in (0, 1]")
            if int(tn.priority) != tn.priority:
                raise ValueError(f"tenant {tn.name!r}: priority must be "
                                 "an integer")
            if not isinstance(tn.model, str):
                raise ValueError(f"tenant {tn.name!r}: model is a string "
                                 "label")
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique (got {names})")
    if any(p.tenants is not None for p in pools):
        raise ValueError("dedicated tenant pools (PoolSpec.tenants) fence "
                         "placement per worker — reference engine only")
    if scenario.workload is None and tenants is None:
        raise ValueError("scenario needs a workload trace")
    if scenario.slo.ttft <= 0 or scenario.slo.atgt <= 0:
        raise ValueError("SLO targets must be positive "
                         f"(ttft={scenario.slo.ttft}, "
                         f"atgt={scenario.slo.atgt})")
    if not topo.heartbeat > 0:
        raise ValueError("heartbeat must be a positive interval "
                         f"(got {topo.heartbeat})")
    if not 0.0 < topo.theta <= 1.0:
        raise ValueError(f"theta must be in (0, 1] (got {topo.theta})")
    if not math.isfinite(topo.gamma):
        raise ValueError(f"gamma must be finite (got {topo.gamma})")
    if int(topo.max_batch) < 1:
        raise ValueError(f"max_batch must be >= 1 (got {topo.max_batch})")
    if not isinstance(topo.rebalance, bool):
        raise ValueError("rebalance must be a bool "
                         f"(got {topo.rebalance!r})")
    if int(scenario.seed) < 0:
        raise ValueError(f"seed must be non-negative (got {scenario.seed})")
    if scenario.engine not in ("reference", "vectorized", "jax"):
        raise ValueError(f"unknown engine {scenario.engine!r}")
    return specs


def check_trace_session_free(trace) -> None:
    """Reject session-tagged traces on the compiled engines.

    The compiled cores price every prefill at full context: a multi-turn
    trace from ``session_trace`` would silently lose its prefix-cache
    discount (and its sticky-routing semantics), so fail loudly instead."""
    for r in trace:
        if r.session_id >= 0:
            raise ValueError(
                "session-tagged traces (multi-turn workloads from "
                "session_trace) are reference-engine only — rerun with "
                f"engine='reference' (request {r.id} carries "
                f"session_id={r.session_id})")


def _managed_scfg(scenario):
    """The ``ScaleSimConfig`` a policy-scaled scenario resolves to (the same
    resolution path ``api._run_colocated`` uses)."""
    from repro_torch.serving import api

    if isinstance(scenario.scaling, api.PolicyScale):
        return scenario.scaling.scfg
    pools = scenario.fleet.for_role("serve")
    return api._scale_cfg(scenario.scaling, sum(p.count for p in pools))


def _managed_policy(scenario, scfg):
    """Build the scaling policy instance exactly like the reference path."""
    from repro_torch.serving import api

    if isinstance(scenario.scaling, api.PolicyScale):
        return scenario.scaling.policy
    spot = scenario.market.spec if scenario.market is not None else None
    return api._build_policy(scenario.scaling, scfg, spot)


class _Lane:
    """Worker adapter handed to the real ``ManagedPool``/``WorkerLifecycle``
    state machines: carries the identity (``id``/``spec``) the lifecycle
    code keys on, plus the engine's row index for this worker."""

    __slots__ = ("id", "spec", "idx", "draining", "alive")

    def __init__(self, wid: int, spec, idx: int):
        self.id = wid
        self.spec = spec
        self.idx = idx
        self.draining = False       # only the fixed+market path sets this
        self.alive = True


class _Engine:
    """One vectorized colocated simulation (struct-of-arrays state)."""

    def __init__(self, specs: Sequence, trace: Sequence[Request], topo, slo,
                 seed: int, tail: float = DEFAULT_TAIL):
        self.policy = topo.policy
        self.hb = float(topo.heartbeat)
        self.gamma = float(topo.gamma)
        self.theta = float(topo.theta)
        self.slo = slo
        self.tail = float(tail)
        self.rng = np.random.default_rng(seed)
        self.specs = list(specs)
        W = len(specs)
        self.W = W

        # ---- per-worker coefficient arrays (+ Python-float twins) ----------
        self.K1 = np.array([s.perf.prefill.k1 for s in specs])
        self.C1 = np.array([s.perf.prefill.c1 for s in specs])
        self.K2 = np.array([s.perf.decode.k2 for s in specs])
        self.C2 = np.array([s.perf.decode.c2 for s in specs])
        self.C3 = np.array([s.perf.decode.c3 for s in specs])
        self.H = np.array([s.perf.kv.h for s in specs])
        self.J = np.array([s.perf.kv.j for s in specs])
        self.M = np.array([s.kv_capacity for s in specs])
        self.MAXB = np.array([s.max_batch for s in specs], dtype=np.int64)
        # capacity_norm denominators: max(max_batch, 1) and
        # max(max_total_context(1, atgt) or 1.0, 1.0), fixed per worker
        self.maxb_norm = [max(int(s.max_batch), 1) for s in specs]
        self.cmax_norm = []
        for s in specs:
            cmax = s.perf.decode.max_total_context(1, slo.atgt) or 1.0
            self.cmax_norm.append(max(cmax, 1.0))
        self.coef = [(float(s.perf.prefill.k1), float(s.perf.prefill.c1),
                      float(s.perf.decode.k2), float(s.perf.decode.c2),
                      float(s.perf.decode.c3), float(s.perf.kv.h),
                      float(s.perf.kv.j), float(s.kv_capacity),
                      int(s.max_batch)) for s in specs]

        # ---- request struct-of-arrays (sorted by arrival, stable) ----------
        order = sorted(range(len(trace)), key=lambda i: trace[i].arrival)
        self.trace = [trace[i] for i in order]
        n = len(self.trace)
        self.n = n
        self.arrival = np.array([r.arrival for r in self.trace])
        self.l_in = np.array([r.l_in for r in self.trace], dtype=np.int64)
        self.l_real = np.array([r.l_real for r in self.trace],
                               dtype=np.int64)
        # no predictor in the envelope: admit() sets l_pred = l_real
        self.l_pred = self.l_real
        # multi-tenant tagging: raw per-request tenant budgets (inf =
        # untagged -> constraints fall back to the planning SLO), the EDF
        # ordering key (arrival + tenant TTFT budget) and the admission
        # priority. ``edf`` (>1 tenant; set by run_colocated_vectorized)
        # orders the queue priority-then-deadline before each placement
        # pass — a single tenant keeps the legacy FIFO walk bit-for-bit.
        self.prio = np.array([r.priority for r in self.trace],
                             dtype=np.int64)
        self.dl = np.array([r.deadline for r in self.trace])
        self.raw_ttft = np.array([r.slo_ttft for r in self.trace])
        self.raw_atgt = np.array([r.slo_atgt for r in self.trace])
        self.tagged = bool(np.isfinite(self.raw_atgt).any()) if n else False
        self.edf = False
        # running per-worker tenant-budget mins for constraints (b)/(c):
        # min tenant ATGT over ongoing+new_batch, min tenant TTFT over
        # new_batch — rebuilt each aladdin pass, updated per placement
        self._amin = np.full(W, np.inf)
        self._tmin = np.full(W, np.inf)
        self.l_out = np.zeros(n, dtype=np.int64)
        self.tds = np.zeros(n)                      # t_decode_spent
        self.t_first = np.full(n, np.nan)
        self.t_fin = np.full(n, np.nan)
        self.t_pre = np.full(n, np.nan)             # t_preempted (KV loss)
        self.preempt_n = np.zeros(n, dtype=np.int64)   # preempt_count delta

        # ---- mutable worker state ------------------------------------------
        Bcap = max(int(self.MAXB.max()), 1) if W else 1
        self.mem = np.full((W, Bcap), -1, dtype=np.int64)   # ongoing members
        self.cnt = np.zeros(W, dtype=np.int64)
        self.bsz = np.zeros(W, dtype=np.int64)      # cnt + len(newb)
        self.t_w = np.zeros(W)                      # local worker clocks
        self.ctx = np.zeros(W, dtype=np.int64)      # Σ context over ongoing
        self.wctx = np.zeros(W)                     # weighted-context cache
        self.dirty = np.ones(W, dtype=bool)
        self.norm = np.zeros(W)                     # capacity_norm cache
        self.newb: List[List[int]] = [[] for _ in range(W)]
        self.pre: List[List[int]] = [[] for _ in range(W)]
        self.newsum = np.zeros(W, dtype=np.int64)   # Σ l_in over newb
        # Σ context over newb (differs from newsum for KV-loss re-entrants,
        # whose retained l_out re-prefills too — what kv_now charges)
        self.newctx = np.zeros(W, dtype=np.int64)
        self.queued: List[int] = []
        self.fin_order: List[int] = []      # finish order (oracle's order)
        self.preemptions = 0
        self.beats = 0
        self.peak_lanes = W                 # topo.peak_workers twin
        self.pool = None                    # worker container, if pooled
        self._wid = 0                       # worker-id counter (pool lanes)

    # ---- dynamic lanes (policy-scaled fleets) ------------------------------

    def _alloc_lane(self, spec) -> int:
        """Append one worker row to every per-lane array; returns its index.
        Policy-scaled fleets boot lanes mid-run — lane rows are never
        recycled, so a retired lane's (empty) row just stops being visited."""
        idx = self.W
        self.W += 1
        self.specs.append(spec)
        for name, val in (("K1", spec.perf.prefill.k1),
                          ("C1", spec.perf.prefill.c1),
                          ("K2", spec.perf.decode.k2),
                          ("C2", spec.perf.decode.c2),
                          ("C3", spec.perf.decode.c3),
                          ("H", spec.perf.kv.h), ("J", spec.perf.kv.j),
                          ("M", spec.kv_capacity)):
            setattr(self, name, np.append(getattr(self, name), val))
        self.MAXB = np.append(self.MAXB, np.int64(spec.max_batch))
        self.maxb_norm.append(max(int(spec.max_batch), 1))
        cmax = spec.perf.decode.max_total_context(1, self.slo.atgt) or 1.0
        self.cmax_norm.append(max(cmax, 1.0))
        self.coef.append((float(spec.perf.prefill.k1),
                          float(spec.perf.prefill.c1),
                          float(spec.perf.decode.k2),
                          float(spec.perf.decode.c2),
                          float(spec.perf.decode.c3), float(spec.perf.kv.h),
                          float(spec.perf.kv.j), float(spec.kv_capacity),
                          int(spec.max_batch)))
        B = self.mem.shape[1] if idx else max(int(spec.max_batch), 1)
        self.mem = np.vstack([self.mem,
                              np.full((1, B), -1, dtype=np.int64)]) \
            if idx else np.full((1, B), -1, dtype=np.int64)
        for name in ("cnt", "bsz", "ctx", "newsum", "newctx"):
            setattr(self, name,
                    np.append(getattr(self, name), np.int64(0)))
        self.t_w = np.append(self.t_w, 0.0)
        self.wctx = np.append(self.wctx, 0.0)
        self.norm = np.append(self.norm, 0.0)
        self.dirty = np.append(self.dirty, True)
        self._amin = np.append(self._amin, np.inf)
        self._tmin = np.append(self._tmin, np.inf)
        self.newb.append([])
        self.pre.append([])
        return idx

    def _grow_mem(self) -> None:
        # resumes can push a batch past max_batch (placement bounds only
        # new admissions, like the scalar engine's unbounded ongoing list)
        W, B = self.mem.shape
        nm = np.full((W, 2 * B), -1, dtype=np.int64)
        nm[:, :B] = self.mem
        self.mem = nm

    # ---- weighted-context / capacity-norm caches ---------------------------

    def _recompute_wctx(self) -> None:
        """Ordered recompute of the weighted-context cache for dirty workers
        (sequential cumsum over ongoing-then-new_batch, like the scalar
        ``_wctx_now``)."""
        g = self.gamma
        for wi in np.nonzero(self.dirty)[0]:
            cnt = int(self.cnt[wi])
            nb = self.newb[wi]
            if cnt == 0 and not nb:
                self.wctx[wi] = 0.0
            else:
                m = self.mem[wi, :cnt]
                vals = self.l_in[m] + g * self.l_pred[m]
                if nb:
                    nba = np.asarray(nb, dtype=np.int64)
                    vals = np.concatenate(
                        [vals, self.l_in[nba] + g * self.l_pred[nba]])
                self.wctx[wi] = np.cumsum(vals)[-1]
            self.dirty[wi] = False

    def _refresh_norms(self, sel: Optional[np.ndarray] = None) -> None:
        for wi in (range(self.W) if sel is None else sel):
            wi = int(wi)
            self.norm[wi] = math.hypot(
                self.bsz[wi] / self.maxb_norm[wi],
                self.wctx[wi] / self.cmax_norm[wi])

    def _kv_peak_with(self, wi: int, ridx: int) -> float:
        cnt = int(self.cnt[wi])
        ids = self.mem[wi, :cnt]
        extra = self.newb[wi] + [ridx]
        ids = np.concatenate([ids, np.asarray(extra, dtype=np.int64)])
        rem = np.maximum(self.l_pred[ids] - self.l_out[ids], 0)
        ctx = self.l_in[ids] + self.l_out[ids]
        _, _, _, _, _, h, j, _, _ = self.coef[wi]
        return kv_peak_arrays(rem, ctx, h, j)

    # ---- placement ---------------------------------------------------------

    def _place(self, wi: int, ridx: int, v: float, li: int) -> None:
        self.newb[wi].append(ridx)
        self.newsum[wi] += li
        self.newctx[wi] += li + int(self.l_out[ridx])
        self.bsz[wi] += 1
        self.wctx[wi] += v
        self.norm[wi] = math.hypot(
            self.bsz[wi] / self.maxb_norm[wi],
            self.wctx[wi] / self.cmax_norm[wi])
        if self.tagged:
            # the new member's tenant budgets tighten the worker's running
            # constraint-(b)/(c) mins for the rest of the pass
            if self.raw_atgt[ridx] < self._amin[wi]:
                self._amin[wi] = self.raw_atgt[ridx]
            if self.raw_ttft[ridx] < self._tmin[wi]:
                self._tmin[wi] = self.raw_ttft[ridx]

    # Placement runs over the *serving* lanes in serving-list order: ``sel``
    # (None = every lane, the fixed-fleet fast path) maps serving position ->
    # lane row, so best-fit/JSQ tie-breaks keep the reference's list order
    # even when a pool boots, drains and reclaims lanes out of index order.

    def _place_all_aladdin(self, sel: Optional[np.ndarray] = None) -> None:
        theta = self.theta
        atgt = self.slo.atgt
        ttft = self.slo.ttft
        g = self.gamma
        self._recompute_wctx()
        self._refresh_norms(sel)
        if sel is None:
            def sub(a):
                return a
        else:
            def sub(a):
                return a[sel]
        # constraint (d) slack is over *ongoing* members only — fixed for
        # the whole placement pass
        B = self.mem.shape[1]
        mem_s = sub(self.mem)
        mask_slots = np.arange(B)[None, :] < sub(self.cnt)[:, None]
        slack = slack_arrays(self.l_out[mem_s], self.tds[mem_s],
                             mask_slots, atgt)
        d_budget = theta * np.maximum(slack, 0.0)
        tagged = self.tagged
        d_budget_tag = None
        if tagged:
            # per-member tenant ATGT budgets (inf -> planning SLO) for the
            # tagged-candidate variant of the (d) slack, plus the rebuilt
            # running (b)/(c) mins over ongoing + any pending new batch
            raw_am = self.raw_atgt[mem_s]
            atgt_mem = np.where(np.isinf(raw_am), atgt, raw_am)
            slack_t = slack_arrays(self.l_out[mem_s], self.tds[mem_s],
                                   mask_slots, atgt_mem)
            d_budget_tag = theta * np.maximum(slack_t, 0.0)
            live = np.arange(self.W) if sel is None else sel
            amin = np.where(mask_slots, raw_am, np.inf).min(axis=1)
            tmin = np.full(live.size, np.inf)
            for p, wi in enumerate(live):
                for rid in self.newb[int(wi)]:
                    if self.raw_atgt[rid] < amin[p]:
                        amin[p] = self.raw_atgt[rid]
                    if self.raw_ttft[rid] < tmin[p]:
                        tmin[p] = self.raw_ttft[rid]
            self._amin[live] = amin
            self._tmin[live] = tmin
        K1_s, C1_s = sub(self.K1), sub(self.C1)
        K2_s, C2_s, C3_s = sub(self.K2), sub(self.C2), sub(self.C3)
        MAXB_s = sub(self.MAXB)
        still: List[int] = []
        for ridx in self.queued:
            li = int(self.l_in[ridx])
            v = li + g * int(self.l_pred[ridx])
            bpost = sub(self.bsz) + 1
            if tagged and math.isfinite(self.raw_atgt[ridx]):
                # tagged candidate: constraints budget against the
                # strictest tenant among candidate + affected members,
                # mirroring WorkerState._constraint_{b,c,d}
                a_eff = np.minimum(sub(self._amin), self.raw_atgt[ridx])
                a_eff = np.where(np.isinf(a_eff), atgt, a_eff)
                t_eff = np.minimum(sub(self._tmin), self.raw_ttft[ridx])
                t_eff = np.where(np.isinf(t_eff), ttft, t_eff)
                d_eff = d_budget_tag
            else:
                a_eff, t_eff, d_eff = atgt, ttft, d_budget
            okb = (bpost <= MAXB_s) & (
                sub(self.wctx) + v <= theta * decode_budget_arrays(
                    bpost, a_eff, K2_s, C2_s, C3_s))
            pre_t = K1_s * (sub(self.newsum) + li) + C1_s
            mask = okb & (pre_t <= t_eff) & (pre_t <= d_eff)
            placed = False
            if mask.any():
                for p in best_fit_order(sub(self.norm)):
                    p = int(p)
                    if not mask[p]:
                        continue
                    wi = p if sel is None else int(sel[p])
                    if self._kv_peak_with(wi, ridx) \
                            <= theta * self.coef[wi][7]:
                        self._place(wi, ridx, v, li)
                        placed = True
                        break
            if not placed:
                still.append(ridx)
        self.queued[:] = still

    def _place_all_jsq(self, sel: Optional[np.ndarray] = None) -> None:
        if sel is None:
            def sub(a):
                return a
        else:
            def sub(a):
                return a[sel]
        H_s, J_s, M_s = sub(self.H), sub(self.J), sub(self.M)
        MAXB_s = sub(self.MAXB)
        still: List[int] = []
        for ridx in self.queued:
            li = int(self.l_in[ridx])
            # Σ context incl. new_batch (newctx: re-entrants count l_out too)
            csum = sub(self.ctx) + sub(self.newctx)
            bsz_s = sub(self.bsz)
            kv_now = (H_s * csum + J_s * bsz_s) + (H_s * li + J_s)
            mask = (kv_now <= M_s) & (bsz_s + 1 <= MAXB_s)
            order = jsq_order(bsz_s)
            hit = np.nonzero(mask[order])[0]
            if hit.size:
                p = int(order[hit[0]])
                wi = p if sel is None else int(sel[p])
                self._place(wi, ridx, li + self.gamma * int(
                    self.l_pred[ridx]), li)
            else:
                still.append(ridx)
        self.queued[:] = still

    def _admit_naive_scalar(self, wi: int, li: int) -> bool:
        _, _, _, _, _, h, j, M, maxb = self.coef[wi]
        csum = int(self.ctx[wi]) + int(self.newctx[wi])
        own = int(self.bsz[wi])
        kv_now = (h * csum + j * own) + (h * li + j)
        return kv_now <= M and own + 1 <= maxb

    def _place_all_po2(self, sel: Optional[np.ndarray] = None) -> None:
        self._recompute_wctx()
        g = self.gamma
        nlive = self.W if sel is None else int(sel.size)
        still: List[int] = []
        for ridx in self.queued:
            li = int(self.l_in[ridx])
            v = li + g * int(self.l_pred[ridx])
            wctx_live = self.wctx if sel is None else self.wctx[sel]
            if nlive >= 2:
                i, jj = self.rng.choice(nlive, size=2, replace=False)
                cands = sorted((int(i), int(jj)),
                               key=lambda p: wctx_live[p])
            else:
                cands = list(range(nlive))
            placed = False
            for p in cands:
                wi = p if sel is None else int(sel[p])
                if self._admit_naive_scalar(wi, li):
                    self._place(wi, ridx, v, li)
                    placed = True
                    break
            if not placed:
                for p in np.argsort(wctx_live, kind="stable"):
                    p = int(p)
                    if p in cands:
                        continue
                    wi = p if sel is None else int(sel[p])
                    if self._admit_naive_scalar(wi, li):
                        self._place(wi, ridx, v, li)
                        placed = True
                        break
            if not placed:
                still.append(ridx)
        self.queued[:] = still

    # ---- worker advance ----------------------------------------------------

    def _advance(self, wi: int, t_start: float, t_end: float) -> None:
        k1, c1, k2, c2, c3, h, j, M, _ = self.coef[wi]
        mem = self.mem
        l_in = self.l_in
        l_out = self.l_out
        l_real = self.l_real
        tds = self.tds
        t_first = self.t_first
        t_fin = self.t_fin
        t_pre = self.t_pre
        arrival = self.arrival
        t = float(self.t_w[wi])
        cnt = int(self.cnt[wi])
        ctx = int(self.ctx[wi])
        newb = self.newb[wi]
        pre = self.pre[wi]
        # a lane that sat booting/idle clamps to the beat start before any
        # pending work runs (the reference's advance_to t_start clamp)
        if (newb or pre) and t < t_start:
            t = t_start
        resume_thr = 0.9 * M
        while t < t_end:
            # resume preempted requests when KV frees up (recompute: prompt
            # AND generated tokens re-prefill). Like the scalar engine, the
            # admission test uses the pre-resume occupancy for every pop.
            resume: List[int] = []
            while pre:
                cand = pre[0]
                occ = (h * ctx + j * cnt) \
                    + h * (int(l_in[cand]) + int(l_out[cand])) + j
                if occ > resume_thr:
                    break
                resume.append(pre.pop(0))
            if newb or resume:
                total_in = sum(int(l_in[r]) + int(l_out[r]) for r in newb) \
                    + sum(int(l_in[r]) + int(l_out[r]) for r in resume)
                dur = k1 * total_in + c1
                t += dur
                # prefill preempts decode: ongoing + still-preempted +
                # resumed victims all stall through it
                if cnt:
                    tds[mem[wi, :cnt]] += dur
                for r in pre:
                    tds[r] += dur
                for r in resume:
                    tds[r] += dur
                for r in newb:
                    if math.isnan(t_first[r]):
                        t_first[r] = t
                        l_out[r] = 1
                    elif not math.isnan(t_pre[r]):
                        # KV-loss re-entrant: the stall since the reclaim
                        # instant lands on its ATGT clock
                        tds[r] += max(t - float(t_pre[r]), 0.0)
                    t_pre[r] = np.nan
                    if cnt == mem.shape[1]:
                        self._grow_mem()
                        mem = self.mem
                    mem[wi, cnt] = r
                    cnt += 1
                    ctx += int(l_in[r]) + int(l_out[r])
                for r in resume:
                    if cnt == mem.shape[1]:
                        self._grow_mem()
                        mem = self.mem
                    mem[wi, cnt] = r
                    cnt += 1
                    ctx += int(l_in[r]) + int(l_out[r])
                newb.clear()
                self.newsum[wi] = 0
                self.newctx[wi] = 0
                continue
            if cnt == 0:
                t = t_end
                break
            # KV overflow -> preempt the youngest (recompute semantics)
            while h * ctx + j * cnt > M and cnt > 1:
                row = mem[wi, :cnt]
                vpos = int(np.argmax(arrival[row]))
                victim = int(row[vpos])
                ctx -= int(l_in[victim]) + int(l_out[victim])
                mem[wi, vpos:cnt - 1] = mem[wi, vpos + 1:cnt]
                cnt -= 1
                pre.append(victim)
                self.preemptions += 1
            # decode segment: batch fixed until finish/overflow/heartbeat
            b = cnt
            row = mem[wi, :cnt]
            n_fin = int(np.min(np.maximum(l_real[row] - l_out[row], 1)))
            C = ctx
            k = 0
            seg = 0.0
            dur0 = k2 * C + c2 * b + c3
            est = (t_end - t) / dur0 if dur0 > 0 else float(n_fin)
            if n_fin <= _SEG_VECTOR_MIN or est <= _SEG_VECTOR_MIN \
                    or dur0 <= 0:
                while k < n_fin and t < t_end:
                    if k > 0 and h * C + j * b > M and b > 1:
                        break
                    dur = k2 * C + c2 * b + c3
                    t += dur
                    seg += dur
                    C += b
                    k += 1
            else:
                kmax = min(n_fin, int(est) + 2)
                ks = np.arange(kmax, dtype=np.int64)
                C_k = C + ks * b
                cb = c2 * b
                durs = k2 * C_k + cb + c3
                t_traj = np.add.accumulate(
                    np.concatenate(([t], durs)))
                k = int(np.searchsorted(t_traj[:kmax], t_end, side="left"))
                if b > 1:
                    viol = h * C_k + j * b > M
                    viol[0] = False
                    nz = np.nonzero(viol)[0]
                    if nz.size:
                        k = min(k, int(nz[0]))
                if k > 0:
                    seg = float(np.add.accumulate(durs[:k])[-1])
                    t = float(t_traj[k])
                    C += k * b
            ctx = C
            l_out[row] += k
            tds[row] += seg
            done = l_out[row] >= l_real[row]
            if done.any():
                fin_ids = row[done]
                t_fin[fin_ids] = t
                self.fin_order.extend(int(r) for r in fin_ids)
                ctx -= int((l_in[fin_ids] + l_out[fin_ids]).sum())
                kept = row[~done]
                cnt = kept.shape[0]
                mem[wi, :cnt] = kept
            # preempted requests' ATGT clocks also advance (stalled)
            for r in pre:
                tds[r] += seg
        self.t_w[wi] = t
        self.cnt[wi] = cnt
        self.ctx[wi] = ctx
        self.bsz[wi] = cnt + len(newb)
        self.dirty[wi] = True

    # ---- the heartbeat loop ------------------------------------------------

    def _edf_sort(self) -> None:
        """Priority-then-EDF queue ordering (>1 tenant only): stable sort
        by (-priority, deadline), so equal keys keep FIFO/requeue order —
        the same ``list.sort`` the reference topology runs."""
        prio, dl = self.prio, self.dl
        self.queued.sort(key=lambda i: (-prio[i], dl[i]))

    def _step(self, t: float, t_next: float) -> None:
        if self.queued:
            if self.edf:
                self._edf_sort()
            if self.policy == "aladdin":
                self._place_all_aladdin()
            elif self.policy == "jsq":
                self._place_all_jsq()
            else:
                self._place_all_po2()
        t_w = self.t_w
        cnt = self.cnt
        for wi in range(self.W):
            if cnt[wi] == 0 and not self.newb[wi] and not self.pre[wi]:
                # idle worker: the scalar loop just fast-forwards its clock
                if t_w[wi] < t_next:
                    t_w[wi] = t_next
                self.dirty[wi] = True
            else:
                self._advance(wi, t, t_next)

    def _drained(self) -> bool:
        return (not self.queued and int(self.cnt.sum()) == 0
                and all(not nb for nb in self.newb)
                and all(not p for p in self.pre))

    # ---- pool adapters (plugged into the REAL ManagedPool/WorkerLifecycle
    # state machines, which make every boot/drain/kill decision) -------------

    def _new_lane(self, spec) -> _Lane:
        self._wid += 1
        return _Lane(self._wid, spec, self._alloc_lane(spec))

    def _spawn_lane(self, lane: _Lane, t: float) -> None:
        # the reference arms a fresh SimWorker at the boot instant
        self.t_w[lane.idx] = t

    def _kill_lane(self, lane: _Lane) -> List[int]:
        """Strip and return the lane's in-flight requests (ongoing,
        new_batch, KV-preempted — the reference's extraction order)."""
        wi = lane.idx
        cnt = int(self.cnt[wi])
        lost = [int(r) for r in self.mem[wi, :cnt]] \
            + list(self.newb[wi]) + list(self.pre[wi])
        self.cnt[wi] = 0
        self.bsz[wi] = 0
        self.ctx[wi] = 0
        self.newsum[wi] = 0
        self.newctx[wi] = 0
        self.wctx[wi] = 0.0
        self.newb[wi] = []
        self.pre[wi] = []
        self.dirty[wi] = True
        return lost

    def _mark_rid(self, rid: int, t: float) -> None:
        # mark_kv_loss over array state: the stall clock arms at the
        # reclaim instant; settled when the re-prefill completes
        self.t_pre[rid] = t
        self.preempt_n[rid] += 1

    def _lane_load(self, lane: _Lane) -> int:
        return int(self.bsz[lane.idx])

    def _lane_idle(self, lane: _Lane) -> bool:
        wi = lane.idx
        return (int(self.cnt[wi]) == 0 and not self.newb[wi]
                and not self.pre[wi])

    # ---- the ColocatedTopology shim the pools call back into ---------------

    def requeue(self, rids: Sequence[int], side: str = "serve") -> None:
        self.queued.extend(rids)

    def backlog_len(self, side: str = "serve") -> int:
        return len(self.queued)

    def slo_window(self, side: str, t_now: float, window: float,
                   metric: str = "both") -> tuple:
        """``core.slo.windowed_attainment`` over array state: (ok, total)
        among requests finished in ``[t_now - window, t_now]``, plus
        assured-miss pending requests whose TTFT budget already expired."""
        t0 = t_now - window
        inw = ~np.isnan(self.t_fin) & (self.t_fin >= t0)
        ids = np.nonzero(inw)[0]
        total = int(ids.size)
        ok = 0
        if total:
            ttft_ok = (self.t_first[ids] - self.arrival[ids]) \
                <= self.slo.ttft
            has_dec = self.l_real[ids] > 1
            atgt_ok = np.ones(total, dtype=bool)
            d = ids[has_dec]
            atgt_ok[has_dec] = (self.tds[d] / (self.l_real[d] - 1)) \
                <= self.slo.atgt
            if metric == "both":
                okm = ttft_ok & atgt_ok
            elif metric == "ttft":
                okm = ttft_ok
            elif metric == "atgt":
                okm = atgt_ok
            else:
                raise ValueError(f"unknown SLO metric {metric!r}")
            ok = int(okm.sum())
        if metric != "atgt":
            for rid in self.queued:
                if math.isnan(self.t_first[rid]) \
                        and t_now - float(self.arrival[rid]) > self.slo.ttft:
                    total += 1
        return ok, total

    # ---- the pooled heartbeat loop (policy-scaled / fixed+market) ----------

    def _step_pooled(self, t: float, t_next: float) -> None:
        pool = self.pool
        pool.begin_beat(self, t)
        if self.queued:
            if self.edf:
                self._edf_sort()
            sel = np.asarray([ln.idx for ln in pool.serving()
                              if ln.alive and not ln.draining],
                             dtype=np.int64)
            if sel.size:
                if self.policy == "aladdin":
                    self._place_all_aladdin(sel)
                elif self.policy == "jsq":
                    self._place_all_jsq(sel)
                else:
                    self._place_all_po2(sel)
        t_w = self.t_w
        cnt = self.cnt
        for ln in pool.active():
            wi = ln.idx
            if cnt[wi] == 0 and not self.newb[wi] and not self.pre[wi]:
                if t_w[wi] < t_next:
                    t_w[wi] = t_next
                self.dirty[wi] = True
            else:
                self._advance(wi, t, t_next)
        pool.end_beat(self, t, t_next)

    def _drained_pooled(self) -> bool:
        if self.queued:
            return False
        for ln in self.pool.active():
            wi = ln.idx
            if int(self.cnt[wi]) or self.newb[wi]:
                return False
        return all(not p for p in self.pre)

    def run_pooled(self, events: Sequence) -> None:
        """Heartbeat loop with the engine playing ``ColocatedTopology``
        against ``self.pool`` (the real ManagedPool, or ``_FixedLanes`` for
        a market over a fixed fleet). Reclaim events consume ``self.rng``
        before placement draws, exactly like the reference's fire/step
        ordering."""
        pool = self.pool
        n = self.n
        horizon = (float(self.arrival[n - 1]) if n else 0.0) + self.tail
        hb = self.hb
        arr = self.arrival
        nev = len(events)
        t = 0.0
        idx = 0
        eidx = 0
        queued = self.queued
        while t < horizon:
            t_next = t + hb
            while idx < n and arr[idx] <= t:
                queued.append(idx)
                pool.note_arrival()
                idx += 1
            while eidx < nev and events[eidx].t <= t:
                self.requeue(pool.on_reclaim(t, events[eidx]))
                eidx += 1
            self._step_pooled(t, t_next)
            self.beats += 1
            t = t_next
            if idx >= n and self._drained_pooled():
                break

    def run(self) -> None:
        n = self.n
        horizon = (float(self.arrival[n - 1]) if n else 0.0) + self.tail
        hb = self.hb
        arr = self.arrival
        t = 0.0
        idx = 0
        queued = self.queued
        while t < horizon:
            t_next = t + hb
            while idx < n and arr[idx] <= t:
                queued.append(idx)
                idx += 1
            self._step(t, t_next)
            self.beats += 1
            t = t_next
            if idx >= n and self._drained():
                break

    # ---- results -----------------------------------------------------------

    def writeback(self) -> List[Request]:
        """Scatter the array state back onto the ``Request`` objects (the
        same mutation contract as the reference engine) and return the
        finished sublist in *finish order* — ``np.mean``/``np.percentile``
        are pairwise reductions, so matching the oracle's report to the
        last ulp needs the oracle's list order, not just its members."""
        for pos, r in enumerate(self.trace):
            r.l_pred = int(self.l_pred[pos])
            r.l_out = int(self.l_out[pos])
            r.t_decode_spent = float(self.tds[pos])
            tf = self.t_first[pos]
            r.t_first_token = None if math.isnan(tf) else float(tf)
            tp = self.t_pre[pos]
            r.t_preempted = None if math.isnan(tp) else float(tp)
            pn = int(self.preempt_n[pos])
            if pn:
                r.preempt_count += pn
            te = self.t_fin[pos]
            if not math.isnan(te):
                r.t_finish = float(te)
                r.state = ReqState.FINISHED
        return [self.trace[i] for i in self.fin_order]


class _FixedLanes:
    """``simulator.FixedPool`` twin over engine lanes: a static fleet a spot
    market may reclaim workers out of (they are not replaced). All condemn/
    kill/reap decisions run through the shared ``WorkerLifecycle``."""

    def __init__(self, eng: _Engine, lanes: List[_Lane], rng,
                 notice_s: float):
        self.workers = lanes
        self.retired_cost = 0.0
        self.life = WorkerLifecycle(
            rng, notice_s=notice_s, extract=eng._kill_lane,
            mark=eng._mark_rid, idle=eng._lane_idle, remove=self._remove,
            on_condemn=lambda ln: setattr(ln, "draining", True))

    def _remove(self, lane: _Lane) -> None:
        self.workers.remove(lane)
        self.retired_cost += lane.spec.n_accelerators

    @property
    def killed(self) -> int:
        return self.life.killed

    @property
    def drained_ok(self) -> int:
        return self.life.drained_ok

    @property
    def requeued(self) -> int:
        return self.life.requeued

    def note_arrival(self) -> None:
        pass

    def serving(self) -> List[_Lane]:
        return self.workers

    def active(self) -> List[_Lane]:
        return self.workers

    def begin_beat(self, topo, t: float) -> None:
        if self.life.condemned:
            topo.requeue(self.life.reap(t, self._lookup))

    def end_beat(self, topo, t: float, t_next: float) -> None:
        pass

    def _lookup(self, wid: int) -> Optional[_Lane]:
        return next((x for x in self.workers if x.id == wid), None)

    def on_reclaim(self, t: float, ev) -> List[int]:
        return self.life.reclaim(t, ev, self.life.eligible(self.workers))


def run_colocated_vectorized(scenario, seed: Optional[int] = None,
                             tail: float = DEFAULT_TAIL):
    """Run a colocated ``Scenario`` on the struct-of-arrays engine and
    return the same :class:`~repro.serving.api.RunReport` the reference
    engine would produce (bit-for-bit on the supported envelope)."""
    from repro_torch.serving import api
    from repro_torch.serving.forecast import ManagedPool

    scenario = api.resolve_scenario(scenario)
    specs = check_colocated_envelope(scenario)
    s = seed if seed is not None else scenario.seed
    edf = scenario.tenants is not None and len(scenario.tenants) > 1
    trace = scenario.materialize()
    check_trace_session_free(trace)
    market = scenario.market
    notice = market.notice_s if market is not None else 0.0
    events = sorted(market.events, key=lambda e: e.t) \
        if market is not None and market.events else []
    managed = not isinstance(scenario.scaling, api.FixedScale)
    if managed:
        # lanes are booted by the pool itself (the ctor spawns the t=0
        # fleet through the engine's new_worker adapter)
        eng = _Engine([], trace, scenario.topology, scenario.slo, s,
                      tail=tail)
        eng.edf = edf
        scfg = _managed_scfg(scenario)
        policy = _managed_policy(scenario, scfg)
        pool = ManagedPool(
            scenario.fleet.for_role("serve")[0].spec, scfg, policy,
            eng.hb, eng.rng, new_worker=eng._new_lane,
            on_spawn=eng._spawn_lane, on_kill=eng._kill_lane,
            load=eng._lane_load, idle=eng._lane_idle, mark=eng._mark_rid,
            spot_spec=market.spec if market is not None else None,
            notice_s=notice, name="serve")
        eng.pool = pool
        eng.run_pooled(events)
        finished = eng.writeback()
        rep = api.RunReport(
            topology="colocated",
            scaling=getattr(policy, "name", type(policy).__name__),
            **api._percentiles(finished, len(trace), scenario.slo))
        rep.peak_workers = pool.peak
        rep.gpu_seconds = pool.gpu_s
        rep.gpu_cost = pool.gpu_s
        rep.spot_gpu_seconds = pool.spot_gpu_s
        rep.epochs = {"serve": pool.epochs}
    elif market is not None:
        eng = _Engine(specs, trace, scenario.topology, scenario.slo, s,
                      tail=tail)
        eng.edf = edf
        lanes = []
        for wi, sp in enumerate(specs):
            eng._wid += 1
            lanes.append(_Lane(eng._wid, sp, wi))
        pool = _FixedLanes(eng, lanes, eng.rng, notice)
        eng.pool = pool
        eng.run_pooled(events)
        finished = eng.writeback()
        rep = api.RunReport(topology="colocated", scaling="fixed",
                            **api._percentiles(finished, len(trace),
                                               scenario.slo))
        rep.peak_workers = eng.peak_lanes
        # every worker that served counts, including reclaimed ones
        rep.gpu_cost = sum(ln.spec.n_accelerators
                           for ln in pool.workers) + pool.retired_cost
    else:
        eng = _Engine(specs, trace, scenario.topology, scenario.slo, s,
                      tail=tail)
        eng.edf = edf
        pool = None
        eng.run()
        finished = eng.writeback()
        rep = api.RunReport(topology="colocated", scaling="fixed",
                            **api._percentiles(finished, len(trace),
                                               scenario.slo))
        rep.peak_workers = eng.W
        rep.gpu_cost = sum(sp.n_accelerators for sp in specs)
    if pool is not None:
        rep.preempted_workers = pool.killed
        rep.drained_ok = pool.drained_ok
        rep.requeued = pool.requeued
    rep.moves = 0
    rep.beats = eng.beats       # benchmark side channel (not in row())
    if scenario.tenants is not None:
        from repro_torch.serving.tenants import tenant_attainment, tenant_rows
        rep.attainment = tenant_attainment(trace)
        rep.tenant_rows = tenant_rows(trace, list(scenario.tenants),
                                      rep.gpu_cost)
    return rep
