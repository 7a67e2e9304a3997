"""Compiled colocated simulation core (the ``engine="jax"`` path of the
Scenario API), on the CUDA card.

This module imports no JAX. It is the port's counterpart of the
reference's jit core (``repro.serving.fastsim_jax``) and keeps its module
path and public names, so that the copied ``api.py`` and ``fastsim.py``
reach it unchanged: in the port, ``engine="jax"`` means "the compiled
core, on the card". It covers the whole colocated envelope, as the
reference does, with two hand-written kernels that share the lane layout:

* the *whole-trace* core (``kernels/fastsim/csrc/whole_trace.cu``): inert
  KV, fixed ``aladdin``/``jsq`` fleets, no market (``_legacy_ok``). One
  launch runs the whole heartbeat loop of a trace, one CTA per candidate
  fleet size, so :func:`run_candidate_batch` evaluates a whole bracket of
  ``optimize``'s search in one launch, as the reference's ``vmap`` does;
* the *chunked* core (``kernels/fastsim/csrc/chunk.cu``): everything else
  (live KV, ``po2``, policy-scaled fleets, spot markets). The host
  (:class:`_PooledSim`) cuts the beat grid at fleet-mutation boundaries
  (scaling epochs, boot completions, market events, notice deadlines) and
  runs each span of a fixed fleet configuration as one launch; between
  chunks the copied ``ManagedPool``/``_FixedLanes``/``WorkerLifecycle``
  state machines make every boot, drain and kill decision on numpy mirrors
  of the lane state, so reclaim victims come from the same numpy Generator
  stream as in the numpy core. :func:`run_policy_candidate_batch` runs a
  bracket of policy candidates in lockstep, one launch a round, one CTA per
  candidate.

po2 draws its two candidates from a counter-based generator keyed on the
run's seed (``kernels.fastsim.ops.po2_draw``), not from the numpy core's
Generator, so po2 runs are deterministic but agree with the other engines
only in tolerance, as the reference's do.

Every entry point takes ``device``: ``None`` is the CUDA card, and raises
on a machine without one; ``device="cpu"`` runs the kernels' plain
versions. Results agree with the numpy core (``serving/fastsim.py``), which
is bit for bit equal to the reference engine: the kernels keep its
operation order and add no fused multiply-add. The one known difference
is the reference's too: with several tenants the backlog is sorted by a
total rank (priority, deadline, arrival), where the numpy core's stable
sort keeps a requeued request behind an exact-key tie.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.request import ReqState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fastsim import chunk, whole_trace
from repro_torch.kernels.fastsim.ops import (BIG, F_LANES, F_ROWS,
                                             I_LANES, I_ROWS, I_SCALARS,
                                             OVF_QUEUE, OVF_SLOTS,
                                             pack_state, unpack_state)
from repro_torch.serving.fastsim import (DEFAULT_TAIL,
                                         check_colocated_envelope,
                                         check_trace_session_free)


def check_jax_envelope(scenario) -> List:
    """The vectorized-engine envelope, with a positive KV capacity: the
    compiled cores cover all of it (live KV, po2, policy-scaled fleets,
    spot markets). po2 draws from the port's own generator instead of the
    numpy core's Generator, so po2 runs are deterministic but only
    tolerance-comparable to the other engines; everything else agrees with
    the numpy core request by request."""
    specs = check_colocated_envelope(scenario)
    for s in specs:
        if s.kv_capacity <= 0:
            raise ValueError("kv_capacity must be positive")
    market = scenario.market
    if market is not None and market.spec is not None \
            and market.spec.kv_capacity <= 0:
        raise ValueError("kv_capacity must be positive")
    return specs


def _legacy_ok(scenario, specs) -> bool:
    """True when the whole-trace kernel applies (fixed fleet, no market,
    inert KV, aladdin/jsq)."""
    from repro_torch.serving import api

    return (isinstance(scenario.scaling, api.FixedScale)
            and scenario.market is None
            and scenario.topology.policy in ("aladdin", "jsq")
            and all(s.perf.kv.h == 0.0 and s.perf.kv.j == 0.0
                    for s in specs))


def _statics(scenario, specs, horizon: float, edf: bool,
             tagged: bool) -> dict:
    """The static configuration the reference's ``_kernel_for`` closes its
    kernel over, as ``whole_trace``'s keyword arguments."""
    topo = scenario.topology
    cmax_norm = []
    for s in specs:
        cmax = s.perf.decode.max_total_context(1, scenario.slo.atgt) or 1.0
        cmax_norm.append(max(cmax, 1.0))
    coefs = tuple(tuple(getattr(s.perf.prefill, a) for s in specs)
                  for a in ("k1", "c1")) + \
        tuple(tuple(getattr(s.perf.decode, a) for s in specs)
              for a in ("k2", "c2", "c3"))
    return dict(hb=float(topo.heartbeat), horizon=horizon,
                theta=float(topo.theta), gamma=float(topo.gamma),
                ttft=float(scenario.slo.ttft), atgt=float(scenario.slo.atgt),
                policy=topo.policy, coefs=coefs,
                maxb=tuple(int(s.max_batch) for s in specs),
                maxb_norm=tuple(max(int(s.max_batch), 1) for s in specs),
                cmax_norm=tuple(cmax_norm), edf=edf, tagged=tagged)


def _kernel_inputs(scenario, specs, ordered, arrival, l_in, l_real,
                   n_active, device: torch.device, edf: bool):
    """``whole_trace``'s tensors on ``device`` and its keyword arguments."""
    rank_r, ttft_r, atgt_r, tagged = _tenant_arrays(ordered, arrival)
    horizon = float(arrival[-1]) + DEFAULT_TAIL
    f64 = dict(dtype=torch.float64, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    args = (torch.as_tensor(arrival, **f64), torch.as_tensor(l_in, **i64),
            torch.as_tensor(l_real, **i64),
            torch.as_tensor(np.asarray(n_active), **i64),
            torch.as_tensor(rank_r, **i64), torch.as_tensor(ttft_r, **f64),
            torch.as_tensor(atgt_r, **f64))
    return args, _statics(scenario, specs, horizon, edf, tagged)


def _simulate(*inputs, **kw):
    """Run the whole-trace core (see ``_kernel_inputs``); numpy back."""
    args, statics = _kernel_inputs(*inputs, **kw)
    return tuple(o.cpu().numpy() for o in whole_trace(*args, **statics))


def _trace_arrays(trace):
    """The trace in arrival order (a stable sort: ties keep the trace's
    order) and its arrival, l_in and l_real arrays. Each field is read once
    a request, and a trace already in order is not sorted."""
    arrival = np.array([r.arrival for r in trace], dtype=np.float64)
    if (arrival[1:] >= arrival[:-1]).all():
        ordered = list(trace)
    else:
        order = np.argsort(arrival, kind="stable")
        ordered = [trace[i] for i in order.tolist()]
        arrival = arrival[order]
    l_in = np.array([r.l_in for r in ordered], dtype=np.int64)
    l_real = np.array([r.l_real for r in ordered], dtype=np.int64)
    return ordered, arrival, l_in, l_real


def _tenant_arrays(ordered, arrival):
    """Per-request multi-tenant operands for the kernels: the total queue
    rank (priority desc, deadline asc, arrival index — the order a stable
    reference sort converges to; after a requeue an exact-key tie can
    differ, which the tolerance pins absorb) and the RAW per-request SLO
    budgets (``inf`` = untagged; the kernels resolve the fallback to the
    planning SLO in-branch, like the reference). ``tagged`` mirrors the
    reference's trace-level gate (any finite ATGT budget). ``arrival``, the
    requests' arrival times (``_trace_arrays``), gives the deadlines
    (``Request.deadline``: arrival + TTFT budget, the same IEEE add)."""
    n = len(ordered)
    prio = np.array([r.priority for r in ordered], dtype=np.int64)
    ttft_r = np.array([r.slo_ttft for r in ordered], dtype=np.float64)
    atgt_r = np.array([r.slo_atgt for r in ordered], dtype=np.float64)
    rank = np.empty(n, dtype=np.int64)
    rank[np.lexsort((arrival + ttft_r, -prio))] = np.arange(n,
                                                            dtype=np.int64)
    tagged = bool(np.isfinite(atgt_r).any()) if n else False
    return rank, ttft_r, atgt_r, tagged


def _report_from_arrays(scenario, specs, n_active, arrival, l_real, l_out,
                        tds, t_first, t_fin):
    """Replicate ``api._percentiles`` over the result arrays (requests in
    finish order, like the reference's finished list)."""
    from repro_torch.serving import api

    slo = scenario.slo
    n = len(arrival)
    fin = ~np.isnan(t_fin)
    order = np.lexsort((np.arange(n)[fin], t_fin[fin]))
    idx = np.nonzero(fin)[0][order]
    ttfts = t_first[idx] - arrival[idx]
    has_atgt = l_real[idx] > 1
    atgts = tds[idx][has_atgt] / np.maximum(l_real[idx][has_atgt] - 1, 1)
    ok = (ttfts <= slo.ttft)
    ok_atgt = np.ones(len(idx), dtype=bool)
    ok_atgt[has_atgt] = atgts <= slo.atgt
    rep = api.RunReport(
        topology="colocated", scaling="fixed",
        attainment=float(np.sum(ok & ok_atgt)) / max(n, 1),
        p99_atgt=float(np.percentile(atgts, 99)) if len(atgts)
        else float("nan"),
        p99_ttft=float(np.percentile(ttfts, 99)) if len(ttfts)
        else float("nan"),
        mean_atgt=float(np.mean(atgts)) if len(atgts) else float("nan"),
        finished=int(len(idx)), total=n)
    rep.peak_workers = int(n_active)
    rep.gpu_cost = sum(s.n_accelerators for s in specs[:n_active])
    rep.moves = 0
    return rep


# ---- the chunked core's host half --------------------------------------------

# mirror layout: per-lane coefficient/clock arrays and per-slot row arrays
# (grown by doubling; rows are recycled once a lane leaves every pool list)
_LANE_KEYS = F_LANES + ("jc", "pc", "MAXB")
_ROW_KEYS = I_ROWS + F_ROWS
_NAN_KEYS = ("rtf1", "rtpe", "rtfn")
_ONE_KEYS = ("MAXB", "MAXBN", "CMAXN")
_INT_KEYS = set(I_LANES + I_ROWS)
_OVF = I_SCALARS.index("ovf")        # its offset in the int64 buffer


def _to_device(arrays, dev: torch.device) -> List[torch.Tensor]:
    """Host arrays as tensors on ``dev`` (a copy to the card; the CPU
    shares the arrays' memory)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _to_host(tensors) -> List[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


class _PooledSim:
    """Host half of the chunked compiled core.

    The kernel advances beats inside a fixed fleet configuration; this
    class owns everything between chunks: numpy mirrors of the lane state,
    the copied ``ManagedPool``/``_FixedLanes``/``WorkerLifecycle`` state
    machines (driven through the same adapter protocol the numpy core
    uses, so every scaling/reclaim decision — including the victim rng
    draws — is made by the reference's code on the numpy core's
    Generator), and the beat-grid bookkeeping that cuts chunks at
    fleet-mutation boundaries: scaling epochs, boot completions, market
    events, notice deadlines, and the horizon."""

    def __init__(self, scenario, seed: Optional[int] = None,
                 tail: float = DEFAULT_TAIL, device: DeviceLike = None):
        from repro_torch.serving import api
        from repro_torch.serving.fastsim import (_FixedLanes,
                                                 _managed_policy,
                                                 _managed_scfg)
        from repro_torch.serving.forecast import ManagedPool

        self.dev = resolve_device(device)
        scenario = api.resolve_scenario(scenario)
        self.scenario = scenario
        self.specs0 = check_jax_envelope(scenario)
        topo = scenario.topology
        self.policy_name = topo.policy
        self.hb = float(topo.heartbeat)
        self.gamma = float(topo.gamma)
        self.theta = float(topo.theta)
        self.slo = scenario.slo
        s = seed if seed is not None else scenario.seed
        self.rng = np.random.default_rng(s)
        # po2's generator: keyed on the run's seed, its draw counter
        # carried in the packed state across chunks
        self.seed = int(s) & ((1 << 63) - 1)
        self.draws = 0
        trace = scenario.materialize()
        check_trace_session_free(trace)
        self.trace, self.arrival, self.l_in, self.l_real = \
            _trace_arrays(trace)
        self.n = len(self.trace)
        self.rank_r, self.ttft_r, self.atgt_r, self.tagged = \
            _tenant_arrays(self.trace, self.arrival)
        self.edf = (scenario.tenants is not None
                    and len(scenario.tenants) > 1 and self.n > 0)
        self._trace_dev = None
        horizon = (float(self.arrival[-1]) if self.n else 0.0) + tail
        grid = [0.0]
        while grid[-1] < horizon:    # the reference's sequential t += hb
            grid.append(grid[-1] + self.hb)
        self.G = np.array(grid)
        self.total_beats = len(grid) - 1
        market = scenario.market
        self.notice = float(market.notice_s) if market is not None else 0.0
        self.events = sorted(market.events, key=lambda e: e.t) \
            if market is not None and market.events else []
        self.managed = not isinstance(scenario.scaling, api.FixedScale)
        cand_specs = list(self.specs0)
        if market is not None and market.spec is not None:
            cand_specs.append(market.spec)
        maxb = max(max(int(sp.max_batch) for sp in cand_specs), 1)
        live_kv = any(sp.perf.kv.h != 0.0 or sp.perf.kv.j != 0.0
                      for sp in cand_specs)
        # live KV parks preempted rows in-lane, and finished rows park
        # in-slot as state 5 until the host drains them between chunks:
        # slots are transient scratch, not a capacity model. Start small;
        # the kernel flags slot exhaustion (ovf) and the drivers regrow B
        # and re-run the chunk. A lane never holds more than the trace's n
        # rows, so the regrowth ends.
        self.B = max(min(2 * maxb + 8 if live_kv else maxb, 64), 1)
        # queue capacity is host-presized per chunk (arrivals are known)
        self.qcap = max(1, min(self.n, 64))
        self.W_cap = 8
        self.specs: List = []
        self._wid = 0
        n = self.n
        W, B = self.W_cap, self.B
        self.m = {}
        for k in _LANE_KEYS:
            dt = np.int64 if k in _INT_KEYS else np.float64
            self.m[k] = np.ones(W, dt) if k in _ONE_KEYS \
                else np.zeros(W, dt)
        for k in _ROW_KEYS:
            dt = np.int64 if k in _INT_KEYS else np.float64
            self.m[k] = np.full((W, B), np.nan) if k in _NAN_KEYS \
                else np.zeros((W, B), dt)
        self.m.update(
            o_lo=np.zeros(n, np.int64), o_tds=np.zeros(n),
            o_tf1=np.full(n, np.nan), o_tfn=np.full(n, np.nan),
            s_lo=np.zeros(n, np.int64), s_tds=np.zeros(n),
            s_tf1=np.full(n, np.nan), s_tpe=np.full(n, np.nan))
        # o_*: the (n,) request outputs, fed from finished rows; s_*: the
        # re-entrant sinks, kernel operands written only between chunks by
        # the lane adapters
        self.h_pn = np.zeros(n, np.int64)   # preempt_count deltas
        self._queue: List[int] = []
        self.idx = 0
        self.eidx = 0
        self.beat = 0
        self.seqc = 0
        self.done = False
        self.pool = None
        self.chunks = 0                     # chunks absorbed
        if self.managed:
            scfg = _managed_scfg(scenario)
            pol = _managed_policy(scenario, scfg)
            self.scaling_policy = pol
            self.pool = ManagedPool(
                scenario.fleet.for_role("serve")[0].spec, scfg, pol,
                self.hb, self.rng, new_worker=self._new_lane,
                on_spawn=self._spawn_lane, on_kill=self._kill_lane,
                load=self._lane_load, idle=self._lane_idle,
                mark=self._mark_rid,
                spot_spec=market.spec if market is not None else None,
                notice_s=self.notice, name="serve")
        else:
            lanes = [self._new_lane(sp) for sp in self.specs0]
            self.init_W = len(lanes)
            self.pool = _FixedLanes(self, lanes, self.rng, self.notice)

    # ---- lane allocation (grow-only mirrors, recycled rows) ----------------

    def _ensure_cap(self, need: int) -> None:
        if need <= self.W_cap:
            return
        cap = self.W_cap
        while cap < need:
            cap *= 2
        ext = cap - self.W_cap
        for k in _LANE_KEYS:
            fill = np.ones(ext, self.m[k].dtype) if k in _ONE_KEYS \
                else np.zeros(ext, self.m[k].dtype)
            self.m[k] = np.concatenate([self.m[k], fill])
        for k in _ROW_KEYS:
            fill = np.full((ext, self.B), np.nan) if k in _NAN_KEYS \
                else np.zeros((ext, self.B), self.m[k].dtype)
            self.m[k] = np.vstack([self.m[k], fill])
        self.W_cap = cap

    def _ensure_rows(self, B: int) -> None:
        """Grow the per-lane row dimension to ``B`` (slot exhaustion
        recovery)."""
        if B <= self.B:
            return
        ext = B - self.B
        for k in _ROW_KEYS:
            fill = np.full((self.W_cap, ext), np.nan) if k in _NAN_KEYS \
                else np.zeros((self.W_cap, ext), self.m[k].dtype)
            self.m[k] = np.hstack([self.m[k], fill])
        self.B = B

    def _live_idx(self) -> set:
        if self.pool is None:       # pool ctor is mid-boot: nothing retired
            return set(range(len(self.specs)))
        live = {ln.idx for ln in self.pool.active()}
        if self.managed:
            live |= {b[1].idx for b in self.pool.booting}
        return live

    def _new_lane(self, spec):
        from repro_torch.serving.fastsim import _Lane

        live = self._live_idx()
        free = [i for i in range(len(self.specs)) if i not in live]
        if free:
            idx = free[0]
            self.specs[idx] = spec
        else:
            idx = len(self.specs)
            self._ensure_cap(idx + 1)
            self.specs.append(spec)
        m = self.m
        m["t_w"][idx] = 0.0
        m["jc"][idx] = 0
        m["pc"][idx] = 0
        m["K1"][idx] = spec.perf.prefill.k1
        m["C1"][idx] = spec.perf.prefill.c1
        m["K2"][idx] = spec.perf.decode.k2
        m["C2"][idx] = spec.perf.decode.c2
        m["C3"][idx] = spec.perf.decode.c3
        m["H"][idx] = spec.perf.kv.h
        m["J"][idx] = spec.perf.kv.j
        m["M"][idx] = spec.kv_capacity
        m["MAXB"][idx] = int(spec.max_batch)
        m["MAXBN"][idx] = max(int(spec.max_batch), 1)
        cmax = spec.perf.decode.max_total_context(1, self.slo.atgt) or 1.0
        m["CMAXN"][idx] = max(cmax, 1.0)
        for k in _ROW_KEYS:
            m[k][idx] = np.nan if k in _NAN_KEYS else 0
        self._wid += 1
        return _Lane(self._wid, spec, idx)

    # ---- pool/lifecycle adapters (mirror-backed) ---------------------------

    def _spawn_lane(self, lane, t: float) -> None:
        self.m["t_w"][lane.idx] = t

    def _kill_lane(self, lane) -> List[int]:
        """Extraction in the reference's order: ongoing (join order), new
        batch (placement order), KV-preempted (preemption order). Row
        state is parked in the re-entrant sinks; the lifecycle's mark
        callback then stamps ``s_tpe``."""
        wi = lane.idx
        m = self.m
        sst = m["sst"][wi]
        parts = []
        for state, okey in ((2, "rjsq"), (1, "rnsq"), (3, "rpsq")):
            slots = np.nonzero(sst == state)[0]
            parts.append(slots[np.argsort(m[okey][wi][slots],
                                          kind="stable")])
        lost = []
        for slot in np.concatenate(parts):
            r = int(m["rid"][wi, slot])
            m["s_lo"][r] = m["rlo"][wi, slot]
            m["s_tds"][r] = m["rtds"][wi, slot]
            m["s_tf1"][r] = m["rtf1"][wi, slot]
            m["s_tpe"][r] = m["rtpe"][wi, slot]
            lost.append(r)
        m["sst"][wi] = 0
        return lost

    def _mark_rid(self, rid: int, t: float) -> None:
        self.m["s_tpe"][rid] = t
        self.h_pn[rid] += 1

    def _lane_load(self, lane) -> int:
        sst = self.m["sst"][lane.idx]
        return int(np.sum((sst == 1) | (sst == 2)))

    def _lane_idle(self, lane) -> bool:
        return not (self.m["sst"][lane.idx] > 0).any()

    # ---- the ColocatedTopology shim the pools call back into ---------------

    def requeue(self, rids, side: str = "serve") -> None:
        self._queue.extend(int(r) for r in rids)

    def backlog_len(self, side: str = "serve") -> int:
        return len(self._queue)

    def slo_window(self, side: str, t_now: float, window: float,
                   metric: str = "both") -> tuple:
        m = self.m
        t0 = t_now - window
        tfn = m["o_tfn"]
        inw = ~np.isnan(tfn) & (tfn >= t0)
        ids = np.nonzero(inw)[0]
        total = int(ids.size)
        ok = 0
        if total:
            ttft_ok = (m["o_tf1"][ids] - self.arrival[ids]) \
                <= self.slo.ttft
            has_dec = self.l_real[ids] > 1
            atgt_ok = np.ones(total, dtype=bool)
            d = ids[has_dec]
            atgt_ok[has_dec] = (m["o_tds"][d] / (self.l_real[d] - 1)) \
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
            for rid in self._queue:
                if math.isnan(m["s_tf1"][rid]) \
                        and t_now - float(self.arrival[rid]) \
                        > self.slo.ttft:
                    total += 1
        return ok, total

    # ---- chunk orchestration -----------------------------------------------

    def _grid_beat(self, x: float) -> int:
        """First beat index b with G[b] >= x (the beat at which a
        time-armed transition fires under the reference's ``<= t`` test)."""
        return int(np.searchsorted(self.G, x, side="left"))

    def _boundary(self) -> None:
        """The host-side slice of one beat start: admit arrivals, fire
        market events, run ``begin_beat`` (boot onlining + reaps) — the
        reference's exact per-beat order. In-chunk beats run the admission
        step in the kernel; everything else is a no-op off-boundary by
        construction of the chunk cuts."""
        t = self.G[self.beat]
        while self.idx < self.n and self.arrival[self.idx] <= t:
            self._queue.append(self.idx)
            self.pool.note_arrival()
            self.idx += 1
        while self.eidx < len(self.events) \
                and self.events[self.eidx].t <= t:
            self.requeue(self.pool.on_reclaim(t, self.events[self.eidx]))
            self.eidx += 1
        self.pool.begin_beat(self, t)

    def _chunk_len(self) -> int:
        """Beats until the next fleet-mutation boundary (always >= 1: the
        boundary processing above already consumed everything due now)."""
        b = self.beat
        cands = [self.total_beats - b]
        if self.eidx < len(self.events):
            cands.append(self._grid_beat(self.events[self.eidx].t) - b)
        for dl in self.pool.life.condemned.values():
            cands.append(self._grid_beat(dl) - b)
        if self.managed:
            bpe = self.pool.beats_per_epoch
            cands.append(bpe - (self.pool.acc["beat"] % bpe))
            for bt in self.pool.booting:
                cands.append(self._grid_beat(bt[0]) - b)
        return max(min(cands), 1)

    def _pack(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """The packed state for a chunk of ``K`` beats (``chunk_layout``):
        the mirrors, the lane activation masks (mode 2 serving, 3 draining,
        0 off) with each serving lane's rank in the serving list, the
        queue and the chunk's scalars."""
        m = self.m
        W = self.W_cap
        mode = np.zeros(W, np.int64)
        rank = np.full(W, BIG, np.int64)
        p2l = np.zeros(W, np.int64)
        serving = [ln for ln in self.pool.serving()
                   if ln.alive and not ln.draining]
        sset = {id(ln) for ln in serving}
        for p, ln in enumerate(serving):
            mode[ln.idx] = 2
            rank[ln.idx] = p
            p2l[p] = ln.idx
        for ln in self.pool.active():
            if id(ln) not in sset:
                mode[ln.idx] = 3
        vals = dict(m, mode=mode, rank=rank, p2l=p2l,
                    empty_at=np.full(W, BIG, np.int64),
                    t=self.G[self.beat], theta=self.theta, K=K,
                    idx=self.idx, qlen=len(self._queue), seqc=self.seqc,
                    seed=self.seed, draws=self.draws, j=0, busy_pk=0,
                    busy_fin=0, ovf=0, q=self._queue)
        return pack_state(vals, W, self.B, self.qcap)

    def _pull(self, f: np.ndarray, i: np.ndarray) -> Tuple:
        """Unpack a chunk's result into the mirrors; drain the finished
        rows (state 5) into the per-request outputs and free their slots.
        Returns (beats run, busy peak, busy at the last beat, empty_at)."""
        out = unpack_state(f, i, self.W_cap, self.B, self.qcap)
        for k in _LANE_KEYS:
            self.m[k] = out[k].copy()
        for k in _ROW_KEYS:
            self.m[k] = out[k].reshape(self.W_cap, self.B).copy()
        if int(out["ovf"]) & OVF_QUEUE:
            raise RuntimeError("chunk: the admission queue was presized "
                               "too small")
        # drain finished-undrained rows; each rid finishes exactly once,
        # so the scatter is collision-free
        wf, sf = np.nonzero(self.m["sst"] == 5)
        if len(wf):
            r = self.m["rid"][wf, sf]
            self.m["o_lo"][r] = self.m["rlo"][wf, sf]
            self.m["o_tds"][r] = self.m["rtds"][wf, sf]
            self.m["o_tf1"][r] = self.m["rtf1"][wf, sf]
            self.m["o_tfn"][r] = self.m["rtfn"][wf, sf]
            self.m["sst"][wf, sf] = 0
        qlen = int(out["qlen"])
        self._queue = [int(r) for r in out["q"][:qlen]]
        self.idx = int(out["idx"])
        self.seqc = int(out["seqc"])
        self.draws = int(out["draws"])
        return (int(out["j"]), int(out["busy_pk"]), int(out["busy_fin"]),
                out["empty_at"])

    def _settle(self, executed: int, busy_pk: int, busy_fin: int,
                empty_at: np.ndarray, arrivals: int) -> None:
        b0 = self.beat
        if self.managed:
            dts = [float(self.G[b0 + i + 1] - self.G[b0 + i])
                   for i in range(executed)]
            retiring: Dict[int, List] = {}
            for ln in list(self.pool.draining):
                ea = int(empty_at[ln.idx])
                if ea < executed:
                    retiring.setdefault(ea, []).append(ln)
            self.pool.absorb_chunk(self, self.G[b0 + executed], dts,
                                   retiring, busy_fin, busy_pk, arrivals,
                                   len(self._queue))
        self.beat = b0 + executed

    def _host_drained(self) -> bool:
        return (self.idx >= self.n and not self._queue
                and not (self.m["sst"] > 0).any())

    def _ensure_queue(self, K: int) -> None:
        """Pre-size the queue for every request that can be queued during
        the next K beats: the current backlog plus the chunk window's
        arrivals (the trace is known, so the kernel needs no queue-growth
        path)."""
        hi = int(np.searchsorted(self.arrival,
                                 self.G[min(self.beat + K,
                                            self.total_beats)],
                                 side="right")) if self.n else 0
        need = len(self._queue) + max(hi - self.idx, 0)
        while self.qcap < need:
            self.qcap = min(self.qcap * 2, max(self.n, 1))

    def step_prepare(self):
        """One lockstep round's host half: process the boundary and return
        the chunk length (0 when this sim is finished)."""
        if self.done:
            return 0
        self._boundary()
        K = self._chunk_len()
        self._ensure_queue(K)
        self._arr0 = self.idx
        return K

    def step_absorb(self, f: np.ndarray, i: np.ndarray) -> None:
        if self.done:
            return
        executed, busy_pk, busy_fin, empty_at = self._pull(f, i)
        if executed == 0:
            raise RuntimeError("chunked core made no progress")
        self._settle(executed, busy_pk, busy_fin, empty_at,
                     self.idx - self._arr0)
        self.chunks += 1
        if self.beat >= self.total_beats or self._host_drained():
            self.done = True

    def trace_operands(self) -> List[torch.Tensor]:
        """The trace's arrays on the sim's device, made once."""
        if self._trace_dev is None:
            self._trace_dev = _to_device(
                (self.arrival, self.l_in, self.l_real, self.rank_r,
                 self.ttft_r, self.atgt_r), self.dev)
        return self._trace_dev

    def statics(self) -> dict:
        return dict(W=self.W_cap, B=self.B, Q=self.qcap, hb=self.hb,
                    gamma=self.gamma, ttft=float(self.slo.ttft),
                    atgt=float(self.slo.atgt), policy=self.policy_name,
                    edf=self.edf, tagged=self.tagged)

    def run(self) -> None:
        while not self.done:
            K = self.step_prepare()
            (f, i), = _run_chunks([self], [K])
            # slot exhaustion: regrow and re-run the chunk — the kernel
            # leaves its inputs alone and the mirrors are untouched until
            # absorb, so re-execution replays the identical decisions
            while int(i[_OVF]) & OVF_SLOTS:
                self._ensure_rows(self.B * 2)
                (f, i), = _run_chunks([self], [K])
            self.step_absorb(f, i)

    # ---- results -----------------------------------------------------------

    def finish(self):
        """Flush lane-resident and queued re-entrant rows into the
        per-request outputs; returns (l_out, tds, t_first, t_fin,
        t_preempted) arrays."""
        m = self.m
        t_pre = np.full(self.n, np.nan)
        for w, slot in zip(*np.nonzero(m["sst"] > 0)):
            r = int(m["rid"][w, slot])
            m["o_lo"][r] = m["rlo"][w, slot]
            m["o_tds"][r] = m["rtds"][w, slot]
            m["o_tf1"][r] = m["rtf1"][w, slot]
            t_pre[r] = m["rtpe"][w, slot]
        for r in self._queue:
            m["o_lo"][r] = m["s_lo"][r]
            m["o_tds"][r] = m["s_tds"][r]
            m["o_tf1"][r] = m["s_tf1"][r]
            t_pre[r] = m["s_tpe"][r]
        return m["o_lo"], m["o_tds"], m["o_tf1"], m["o_tfn"], t_pre


def _run_chunks(sims: List[_PooledSim], lens: List[int]) -> List[Tuple]:
    """One launch of the chunked core over the sims' packed states (one
    CTA per sim; they share W, B and Q, and the first sim's trace): each
    sim's state for a chunk of ``lens[c]`` beats in, the advanced (fstate,
    istate) back as numpy arrays."""
    s0 = sims[0]
    packs = [s._pack(k) for s, k in zip(sims, lens)]
    host = (np.stack([p[0] for p in packs]), np.stack([p[1] for p in packs]),
            np.stack([s.m["s_lo"] for s in sims]),
            np.stack([np.stack([s.m["s_tds"], s.m["s_tf1"], s.m["s_tpe"]])
                      for s in sims]))
    fs, is_, s_lo, s_f = _to_device(host, s0.dev)
    out = chunk(fs, is_, *s0.trace_operands(), s_lo, s_f, **s0.statics())
    fo, io = _to_host(out)
    return list(zip(fo, io))


def _pooled_report(sim: _PooledSim, writeback: bool):
    o_lo, o_tds, o_tf1, o_tfn, t_pre = sim.finish()
    if writeback:
        for pos, r in enumerate(sim.trace):
            r.l_pred = int(sim.l_real[pos])
            r.l_out = int(o_lo[pos])
            r.t_decode_spent = float(o_tds[pos])
            tf = o_tf1[pos]
            r.t_first_token = None if math.isnan(tf) else float(tf)
            tp = t_pre[pos]
            r.t_preempted = None if math.isnan(tp) else float(tp)
            pn = int(sim.h_pn[pos])
            if pn:
                r.preempt_count += pn
            te = o_tfn[pos]
            if not math.isnan(te):
                r.t_finish = float(te)
                r.state = ReqState.FINISHED
    rep = _report_from_arrays(sim.scenario, sim.specs0, len(sim.specs0),
                              sim.arrival, sim.l_real, o_lo, o_tds, o_tf1,
                              o_tfn)
    pool = sim.pool
    if sim.managed:
        pol = sim.scaling_policy
        rep.scaling = getattr(pol, "name", type(pol).__name__)
        rep.peak_workers = pool.peak
        rep.gpu_seconds = pool.gpu_s
        rep.gpu_cost = pool.gpu_s
        rep.spot_gpu_seconds = pool.spot_gpu_s
        rep.epochs = {"serve": pool.epochs}
    else:
        rep.peak_workers = sim.init_W
        # every worker that served counts, including reclaimed ones
        rep.gpu_cost = sum(ln.spec.n_accelerators
                           for ln in pool.workers) + pool.retired_cost
    rep.preempted_workers = pool.killed
    rep.drained_ok = pool.drained_ok
    rep.requeued = pool.requeued
    rep.moves = 0
    rep.beats = sim.beat        # benchmark side channel (not in row())
    if writeback and sim.scenario.tenants is not None:
        from repro_torch.serving.tenants import (tenant_attainment,
                                                 tenant_rows)
        rep.attainment = tenant_attainment(sim.trace)
        rep.tenant_rows = tenant_rows(sim.trace,
                                      list(sim.scenario.tenants),
                                      rep.gpu_cost)
    return rep


def _run_pooled(scenario, seed: Optional[int] = None,
                device: DeviceLike = None):
    sim = _PooledSim(scenario, seed, device=device)
    sim.run()
    return _pooled_report(sim, writeback=True)


def run_colocated_jax(scenario, seed: Optional[int] = None,
                      device: DeviceLike = None):
    """Run a colocated ``Scenario`` on the compiled core, mutate the
    trace's ``Request`` objects with the outcome (the same contract as the
    other engines) and return the ``RunReport``, with the executed beat
    count in the side channel ``rep.beats``. ``seed`` (default the
    scenario's) keys the chunked core's draws: reclaim victims on the
    numpy Generator, po2's candidates; the whole-trace core draws
    nothing."""
    from repro_torch.serving import api

    dev = resolve_device(device)
    scenario = api.resolve_scenario(scenario)
    specs = check_jax_envelope(scenario)
    trace = scenario.materialize()
    check_trace_session_free(trace)
    ordered, arrival, l_in, l_real = _trace_arrays(trace)
    multi = scenario.tenants is not None and len(scenario.tenants) > 1
    if len(ordered) == 0:
        if not _legacy_ok(scenario, specs):
            # pooled fleets still accrue billing/epochs on an empty trace;
            # the bit-for-bit numpy engine handles that without a kernel
            from repro_torch.serving.fastsim import run_colocated_vectorized
            return run_colocated_vectorized(scenario, seed)
        # nothing to simulate, and the reference drains immediately
        empty = np.array([])
        rep = _report_from_arrays(scenario, specs, len(specs), empty,
                                  empty, empty, empty, empty, empty)
        rep.beats = 0
        return rep
    if not _legacy_ok(scenario, specs):
        # KV pressure / po2 / managed fleets / spot markets: the chunked
        # core with the host-side pool driver
        return _run_pooled(scenario, seed, device=dev)
    l_out, tds, t_first, t_fin, beats = _simulate(
        scenario, specs, ordered, arrival, l_in, l_real, len(specs), dev,
        edf=multi)
    # the outcome as Python ints and floats, column by column (a NaN first
    # token is None; a NaN finish leaves the request as it was)
    finished = ReqState.FINISHED
    for r, lr, lo, td, tf, te in zip(ordered, l_real.tolist(),
                                     l_out.tolist(), tds.tolist(),
                                     t_first.tolist(), t_fin.tolist()):
        r.l_pred = lr
        r.l_out = lo
        r.t_decode_spent = td
        r.t_first_token = None if tf != tf else tf
        if te == te:
            r.t_finish = te
            r.state = finished
    rep = _report_from_arrays(scenario, specs, len(specs), arrival, l_real,
                              l_out, tds, t_first, t_fin)
    rep.beats = int(beats)      # benchmark side channel (not in row())
    if scenario.tenants is not None:
        from repro_torch.serving.tenants import (tenant_attainment,
                                                 tenant_rows)
        rep.attainment = tenant_attainment(ordered)
        rep.tenant_rows = tenant_rows(ordered, list(scenario.tenants),
                                      rep.gpu_cost)
    return rep


def run_candidate_batch(scenarios, device: DeviceLike = None) -> List:
    """Evaluate a batch of fleet-size candidates of the SAME workload /
    spec / policy in one launch, one CTA per candidate — the whole bracket
    of ``optimize``'s search at once. Returns one ``RunReport`` per scenario
    (candidate traces are not mutated; the search only reads reports —
    which is also why multi-tenant candidates keep the planning-SLO
    headline attainment and carry no per-tenant rows: ``optimize``
    evaluates multi-tenant scenarios sequentially instead)."""
    from repro_torch.serving import api

    if not scenarios:
        return []
    dev = resolve_device(device)
    scenarios = [api.resolve_scenario(sc) for sc in scenarios]
    spec_lists = [check_jax_envelope(sc) for sc in scenarios]
    if not all(_legacy_ok(sc, sl)
               for sc, sl in zip(scenarios, spec_lists)):
        # pooled candidates carry host-side fleet state machines that a
        # batch of fleet sizes cannot share; run them through the chunked
        # core one at a time
        return [run_colocated_jax(sc, device=dev) for sc in scenarios]
    base = scenarios[0]
    base_spec = spec_lists[0][0]

    def coef_key(s):
        return (s.perf.prefill.k1, s.perf.prefill.c1, s.perf.decode.k2,
                s.perf.decode.c2, s.perf.decode.c3, s.max_batch,
                s.n_accelerators)

    for sl in spec_lists:
        if any(coef_key(s) != coef_key(base_spec) for s in sl):
            # the candidates share one coefficient set
            raise ValueError("run_candidate_batch needs homogeneous "
                             "candidates of one worker spec")
    W_max = max(len(sl) for sl in spec_lists)
    trace = base.materialize()
    check_trace_session_free(trace)
    ordered, arrival, l_in, l_real = _trace_arrays(trace)
    multi = base.tenants is not None and len(base.tenants) > 1
    padded = [base_spec] * W_max
    n_active = np.array([len(sl) for sl in spec_lists], dtype=np.int64)
    l_out, tds, t_first, t_fin, beats = _simulate(
        base, padded, ordered, arrival, l_in, l_real, n_active, dev,
        edf=multi)
    reps = []
    for i in range(len(scenarios)):
        rep = _report_from_arrays(base, padded, int(n_active[i]), arrival,
                                  l_real, l_out[i], tds[i], t_first[i],
                                  t_fin[i])
        rep.beats = int(beats[i])   # benchmark side channel
        reps.append(rep)
    return reps


def run_policy_candidate_batch(scenarios, device: DeviceLike = None) -> List:
    """Evaluate a batch of policy-knob candidates (same workload and spec
    family, differing theta / scaling parameters) in lockstep: each round
    advances every live candidate's next chunk through ONE launch of the
    chunked core, one CTA per candidate, then settles each candidate's
    fleet boundary on the host. Finished candidates ride along with
    zero-length chunks until the batch drains. Candidate traces are never
    mutated; the policy search only reads the returned reports."""
    if not scenarios:
        return []
    sims = [_PooledSim(sc, device=device) for sc in scenarios]
    s0 = sims[0]
    homog = all(
        s.n == s0.n and s.B == s0.B and s.hb == s0.hb
        and s.gamma == s0.gamma and s.policy_name == s0.policy_name
        and float(s.slo.ttft) == float(s0.slo.ttft)
        and float(s.slo.atgt) == float(s0.slo.atgt)
        and s.edf == s0.edf and s.tagged == s0.tagged
        and np.array_equal(s.arrival, s0.arrival)
        and np.array_equal(s.l_in, s0.l_in)
        and np.array_equal(s.l_real, s0.l_real)
        and np.array_equal(s.rank_r, s0.rank_r)
        and np.array_equal(s.ttft_r, s0.ttft_r)
        and np.array_equal(s.atgt_r, s0.atgt_r)
        for s in sims[1:])
    if len(sims) == 1 or not homog:
        # heterogeneous statics or traces cannot share one launch
        for s in sims:
            s.run()
        return [_pooled_report(s, writeback=False) for s in sims]
    while not all(s.done for s in sims):
        lens = [s.step_prepare() for s in sims]
        cap = max(s.W_cap for s in sims)
        for s, k in zip(sims, lens):  # lockstep: one shared lane axis
            s._ensure_cap(cap)
            s._ensure_queue(k)
        qc = max(s.qcap for s in sims)
        for s in sims:                # ...and a shared queue axis
            s.qcap = qc
        outs = _run_chunks(sims, lens)
        # slot exhaustion in any candidate: regrow every sim to the shared
        # larger capacity and re-run the round
        while any(int(i[_OVF]) & OVF_SLOTS for _f, i in outs):
            B = s0.B * 2
            for s in sims:
                s._ensure_rows(B)
            outs = _run_chunks(sims, lens)
        for s, (f, i) in zip(sims, outs):
            s.step_absorb(f, i)
    return [_pooled_report(s, writeback=False) for s in sims]
