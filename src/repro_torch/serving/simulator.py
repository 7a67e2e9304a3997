"""Discrete-event cluster simulator (paper §6.4's methodology).

Workers advance through prefill/decode iterations whose durations come from
the fitted performance models (Eqs. 2-3); the scheduler (Aladdin best-fit /
JSQ / power-of-two) places requests at heartbeat boundaries, re-balances
against prediction error (Algorithm 2), and the autoscaler (Eq. 7) tracks
demand. Used to measure the minimum worker count that attains the SLOs at a
given arrival rate — the paper's cost metric.

Fleets may be heterogeneous: pass ``fleet`` (a list of ``WorkerSpec``) and
each simulated worker carries its own latency models, KV capacity, batch cap
and accelerator cost. The legacy (perf, kv_capacity) arguments describe a
homogeneous fleet and remain the default."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.placement import (PlacementConfig, WorkerState,
                                  best_fit_place, jsq_place,
                                  power_of_two_place)
from repro_torch.core.rebalance import ErrorTracker, rebalance
from repro_torch.core.request import ReqState, Request
from repro_torch.core.slo import SLO, windowed_attainment
from repro_torch.core.worker_config import WorkerSpec
from repro_torch.serving.length_predictor import LengthPredictor
from repro_torch.serving.lifecycle import WorkerLifecycle, mark_kv_loss


def run_heartbeat_loop(trace: Sequence[Request], heartbeat: float,
                       admit: Callable[[Request], None],
                       step: Callable[[float, float, int], None],
                       drained: Callable[[], bool],
                       tail: float = 240.0,
                       events: Optional[Sequence] = None,
                       fire: Optional[Callable[[float, object], None]]
                       = None) -> List[Request]:
    """Causal-time heartbeat event core shared by every cluster simulator
    (colocated, disaggregated, autoscaled).

    Arrivals are admitted at the first heartbeat boundary ``t >= r.arrival``
    and never before it, so no simulator can see — let alone prefill — a
    request ahead of its arrival timestamp.  ``admit(r)`` is called once per
    request in timestamp order, ``step(t, t_next, arrived)`` runs one
    heartbeat over [t, t_next), and the loop ends when the trace is exhausted
    and ``drained()`` reports every queue empty (or at the horizon = last
    arrival + ``tail``).  Returns the time-sorted trace.

    ``events`` is an optional stream of external cluster events — objects
    with a ``t`` timestamp (e.g. ``workload.PreemptionEvent`` spot reclaims)
    — delivered via ``fire(t, event)`` under the same causal rule as
    arrivals: at the first boundary at-or-after the event time, before the
    heartbeat's ``step``, so a worker death is visible to placement in the
    beat it lands on and never earlier. Events past the drain point of an
    exhausted trace are dropped (there is nothing left for them to kill)."""
    trace = sorted(trace, key=lambda r: r.arrival)
    horizon = (trace[-1].arrival if trace else 0.0) + tail
    evs = sorted(events, key=lambda e: e.t) if events else []
    if evs and fire is None:
        raise ValueError("run_heartbeat_loop: events supplied without a "
                         "fire callback to deliver them")
    n = len(trace)
    idx = 0
    eidx = 0
    t = 0.0
    while t < horizon:
        t_next = t + heartbeat
        while idx < n and trace[idx].arrival <= t:
            admit(trace[idx])
            idx += 1
        while eidx < len(evs) and evs[eidx].t <= t:
            fire(t, evs[eidx])
            eidx += 1
        step(t, t_next, idx)
        t = t_next
        if idx >= n and drained():
            break
    return trace


@dataclasses.dataclass
class SimConfig:
    heartbeat: float = 0.25
    policy: str = "aladdin"          # aladdin | jsq | po2
    split_phase: bool = False        # decode-pool-only simulation (Fig. 12)
    rebalance: bool = True
    gamma: float = 0.5
    theta: float = 0.9
    max_batch: int = 128
    seed: int = 0
    # multi-turn sessions: how session-tagged requests are routed (sticky =
    # prefer the session's previous worker while feasible) and whether
    # workers keep an LRU prefix cache over finished session contexts
    # (cache_tokens caps its footprint; None = spare-KV pressure only).
    # Single-shot traces are arithmetically untouched by either knob.
    router: str = "blind"            # blind | sticky
    prefix_cache: str = "lru"        # lru | off
    cache_tokens: Optional[int] = None


class CacheStats:
    """Shared prefix-cache tally. One instance per topology: per-worker
    caches die with their workers (reclaims, drain retirement), so the
    hit/miss/eviction counts the run report surfaces must outlive them."""

    __slots__ = ("hits", "misses", "hit_tokens", "evictions")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0          # total prefill tokens skipped
        self.evictions = 0           # entries dropped (pressure + vaporize)

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class PrefixCache:
    """Per-worker LRU over finished session prefixes (insertion-ordered
    dict; re-store moves an entry to the back, grant consumes it).

    The cache is a best-effort *renter* of the worker's spare KV: resident
    prefixes occupy ``kv.h`` bytes per token, but they never block
    placement, admission or live decode — the placement constraints and the
    KV-overflow preemption see live KV only, and live growth sheds cache
    entries LRU-first instead (``shed`` runs at every beat boundary, so
    ``h * resident <= capacity - live KV`` holds whenever an observer
    looks). A cache hit prices the next turn's prefill at
    ``context - cached_len``; a miss or eviction repays the full
    re-prefill."""

    def __init__(self, stats: CacheStats, cap_tokens: Optional[int] = None):
        self.stats = stats
        self.cap = cap_tokens
        self.entries: Dict[int, int] = {}   # session_id -> cached tokens
        self.resident = 0                   # Σ entries, tokens

    def peek(self, sid: int, prefix_len: int) -> int:
        """The reuse a grant would return, without consuming the entry
        (sticky routing checks home-worker feasibility with the discount
        the hit would buy, before committing the placement)."""
        ent = self.entries.get(sid)
        if ent is None or prefix_len <= 0:
            return 0
        return min(ent, prefix_len)

    def grant(self, sid: int, prefix_len: int) -> int:
        """Consume the session's entry at placement: the cached blocks
        convert into the request's live KV (full context is charged to the
        worker on admit, so the entry must leave the cache ledger)."""
        if prefix_len <= 0:
            return 0
        ent = self.entries.pop(sid, None)
        if ent is None:
            self.stats.misses += 1
            return 0
        self.resident -= ent
        got = min(ent, prefix_len)
        self.stats.hits += 1
        self.stats.hit_tokens += got
        return got

    def store(self, sid: int, tokens: int) -> None:
        old = self.entries.pop(sid, None)
        if old is not None:
            self.resident -= old
        self.entries[sid] = int(tokens)
        self.resident += int(tokens)
        if self.cap is not None:
            self.shed(self.cap)

    def shed(self, max_tokens: float) -> int:
        """Evict LRU-first until ``resident <= max_tokens``."""
        n = 0
        while self.entries and self.resident > max_tokens:
            sid = next(iter(self.entries))
            self.resident -= self.entries.pop(sid)
            n += 1
        self.stats.evictions += n
        return n

    def vaporize(self) -> int:
        """The worker died (spot reclaim) or retired (drain): every cached
        prefix is gone; returning turns repay their full prefill."""
        n = len(self.entries)
        self.entries.clear()
        self.resident = 0
        self.stats.evictions += n
        return n


class SimWorker:
    """Execution model of one worker: runs iterations in virtual time.

    The decode loop is event-batched: between finish/preemption/heartbeat
    events the batch composition is fixed, so each iteration costs O(1)
    (context sum and KV usage are tracked incrementally; the linear KV model
    makes current usage h·Σcontext + j·b) and per-request bookkeeping is
    applied once per segment instead of once per iteration."""

    def __init__(self, state: WorkerState, perf: PerfModel, now: float,
                 split_phase: bool):
        self.state = state
        self.perf = perf
        self.t = now                    # local clock
        self.split_phase = split_phase
        self.iters = 0
        self.preempted: List[Request] = []   # KV-overflow victims (vLLM
        self.preemptions = 0                 # recompute-preemption semantics)
        self._ctx = 0                        # Σ context over state.ongoing
        self.cache: Optional[PrefixCache] = None   # session prefix cache
                                             # (installed by the topology)

    def _kv_now(self) -> float:
        kv = self.perf.kv
        return kv.h * self._ctx + kv.j * len(self.state.ongoing)

    def _admit(self, r: Request) -> None:
        self.state.ongoing.append(r)
        self._ctx += r.context

    def advance_to(self, t_end: float, finished: List[Request],
                   t_start: Optional[float] = None) -> None:
        w = self.state
        M = w.cfg.kv_capacity
        kv = self.perf.kv
        dec = self.perf.decode
        if t_start is not None and (w.new_batch or self.preempted):
            # work placed at the heartbeat boundary cannot start earlier
            self.t = max(self.t, t_start)
        while self.t < t_end:
            # resume preempted requests when KV frees up (recompute: the
            # prompt AND the already-generated tokens are re-prefilled)
            resume = []
            while self.preempted and self._kv_now() + \
                    kv.h * self.preempted[0].context + kv.j <= 0.9 * M:
                resume.append(self.preempted.pop(0))
            # start any newly placed requests (prefill). A spot-preemption
            # re-entrant (l_out > 0: its worker was reclaimed mid-decode and
            # its KV lost) re-prefills prompt AND generated tokens — context,
            # not l_in — which is the recovery cost the spot mix planner must
            # out-save; for fresh requests context == l_in.
            if (w.new_batch or resume) and not self.split_phase:
                # a prefix-cache hit (cached_len > 0, granted at placement)
                # prices the prefill at the *new* tokens only; resumed
                # KV-overflow victims recompute in full (their cached_len
                # was consumed by their first prefill). Single-shot and
                # cache-off traces carry cached_len == 0: the integer sums
                # below are then bit-for-bit the undiscounted legacy image.
                total_in = sum(r.context - r.cached_len for r in w.new_batch) \
                    + sum(r.context for r in resume)
                dur = float(self.perf.prefill(total_in))
                self.t += dur
                # the prefill preempts decode: ongoing requests stall and
                # their ATGT clocks keep running (this is what constraint (d)
                # budgets and what naive placement ignores). Resumed victims
                # stall through their own re-prefill too — recompute
                # semantics: their decode clock never stopped.
                for r in w.ongoing + self.preempted + resume:
                    r.t_decode_spent += dur
                for r in w.new_batch:
                    if r.t_first_token is None:
                        r.t_first_token = self.t
                        r.l_out = 1
                    elif r.t_preempted is not None:
                        # token stream stalled from the reclaim instant until
                        # this re-prefill finished: queue wait + re-prefill
                        # both burn the ATGT budget (no token was generated)
                        r.t_decode_spent += max(self.t - r.t_preempted, 0.0)
                    r.t_preempted = None
                    r.state = ReqState.DECODING
                    self._admit(r)
                    r.cached_len = 0     # grant consumed by this prefill
                for r in resume:
                    r.state = ReqState.DECODING
                    self._admit(r)
                w.new_batch.clear()
                self.iters += 1
                continue
            if w.new_batch and self.split_phase:
                # decode pool: requests arrive pre-filled (first token — and
                # TTFT — may already be stamped by a disaggregated prefill
                # pool; only stamp it here for decode-pool-only traces)
                for r in w.new_batch:
                    if r.t_first_token is None:
                        r.t_first_token = self.t
                    elif r.t_preempted is not None:
                        # spot-preemption re-entrant: only the stall since
                        # the reclaim burns budget (decode time before it is
                        # already on the clock)
                        r.t_decode_spent += max(self.t - r.t_preempted, 0.0)
                    else:
                        # disaggregated handoff: KV transfer + decode-queue
                        # wait stalls the token stream after the first token,
                        # so it burns ATGT budget like a prefill stall does
                        r.t_decode_spent += max(self.t - r.t_first_token, 0.0)
                    r.t_preempted = None
                    r.l_out = max(r.l_out, 1)
                    r.state = ReqState.DECODING
                    self._admit(r)
                w.new_batch.clear()
            if self.split_phase and resume:
                for r in resume:
                    r.state = ReqState.DECODING
                    self._admit(r)
            if not w.ongoing:
                self.t = t_end
                break
            # KV overflow -> preempt the youngest requests (recompute mode):
            # their decode clock keeps running against the ATGT SLO.
            while self._kv_now() > M and len(w.ongoing) > 1:
                victim = max(w.ongoing, key=lambda r: r.arrival)
                w.ongoing.remove(victim)
                self._ctx -= victim.context
                victim.state = ReqState.QUEUED
                self.preempted.append(victim)
                self.preemptions += 1
            # decode segment: batch is fixed until the next finish /
            # KV-overflow / heartbeat event
            b = len(w.ongoing)
            n_fin = min(max(r.l_real - r.l_out, 1) for r in w.ongoing)
            C = self._ctx
            k = 0
            seg = 0.0
            while k < n_fin and self.t < t_end:
                if k > 0 and kv.h * C + kv.j * b > M and b > 1:
                    break               # preemption due before next iteration
                dur = dec.k2 * C + dec.c2 * b + dec.c3
                self.t += dur
                seg += dur
                C += b
                k += 1
            self._ctx = C
            self.iters += k
            for r in w.ongoing:
                r.l_out += k
                r.t_decode_spent += seg
            for r in list(w.ongoing):
                if r.l_out >= r.l_real:
                    r.state = ReqState.FINISHED
                    r.t_finish = self.t
                    w.ongoing.remove(r)
                    self._ctx -= r.context
                    finished.append(r)
                    if self.cache is not None and r.session_id >= 0:
                        # the finished turn's KV becomes the session's
                        # cacheable prefix for its next turn
                        self.cache.store(r.session_id, r.context)
            # preempted requests' ATGT clocks also advance (they are stalled)
            for r in self.preempted:
                r.t_decode_spent += seg
        if self.cache is not None:
            # beat-boundary pressure: cached prefixes only rent KV the live
            # batch is not using (h > 0 on any real spec; a degenerate h = 0
            # KV model prices blocks at zero, so nothing needs shedding)
            h = self.perf.kv.h
            if h > 0:
                self.cache.shed((M - self._kv_now()) / h)
        # this call mutated w.ongoing in ways the length-keyed aggregate
        # cache cannot see (a finish + a resume can swap membership at equal
        # length) — force one recompute before the next placement pass
        w.mark_dirty()


@dataclasses.dataclass
class SimResult:
    n_workers_peak: int
    attainment: float
    p99_atgt: float
    p99_ttft: float
    mean_atgt: float
    finished: int
    total: int
    moves: int = 0
    gpu_cost: float = 0.0            # Σ accelerators over the fleet

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def make_worker_state(wid: int, spec: WorkerSpec, cfg: SimConfig,
                      slo: SLO) -> WorkerState:
    """Scheduler-side worker for ``spec`` under the simulation's placement
    knobs — the one construction path every topology and pool kind shares."""
    pcfg = PlacementConfig(gamma=cfg.gamma, theta=cfg.theta,
                           kv_capacity=spec.kv_capacity,
                           max_batch=spec.max_batch,
                           split_phase=cfg.split_phase)
    w = WorkerState(wid, pcfg, spec.perf, slo)
    w.spec = spec
    return w


class FixedPool:
    """Static worker container: the fleet of the classic ``simulate`` path.

    ``factory`` (elastic mode) lets placement open a worker whenever nothing
    fits — the min-cost oracle. A spot market may still reclaim workers out
    of a fixed fleet (they are simply not replaced): with a notice window the
    victim drains (``WorkerState.draining`` keeps placement away) and is
    killed at the deadline if work remains — all driven by the shared
    :class:`~repro.serving.lifecycle.WorkerLifecycle` machine."""

    def __init__(self, workers: List[WorkerState], sims: Dict[int, SimWorker],
                 rng, factory: Optional[Callable[[], WorkerState]] = None,
                 notice_s: float = 0.0):
        self.workers = workers
        self.sims = sims
        self.factory = factory
        self.retired_cost = 0.0     # accelerators of reclaimed/drained
        self.gpu_s = 0.0            # workers; fixed fleets bill no seconds
        self.spot_gpu_s = 0.0
        self.epochs: List = []
        self.life = WorkerLifecycle(
            rng, notice_s=notice_s, extract=self._extract,
            mark=mark_kv_loss, idle=self._is_idle, remove=self._remove,
            on_condemn=lambda w: setattr(w, "draining", True))

    # ---- WorkerLifecycle adapters -------------------------------------------
    def _extract(self, w: WorkerState) -> List[Request]:
        sim = self.sims.get(w.id)
        lost = w.ongoing + w.new_batch + (sim.preempted if sim else [])
        for r in lost:
            r.cached_len = 0    # the granted blocks die with the worker
        w.ongoing.clear()
        w.new_batch.clear()
        w.mark_dirty()
        return lost

    def _is_idle(self, w: WorkerState) -> bool:
        sim = self.sims.get(w.id)
        return not w.ongoing and not w.new_batch \
            and not (sim and sim.preempted)

    def _remove(self, w: WorkerState) -> None:
        self.workers.remove(w)
        self.retired_cost += w.spec.n_accelerators
        sim = self.sims.pop(w.id, None)
        if sim is not None and sim.cache is not None:
            sim.cache.vaporize()    # cached prefixes die with the worker

    @property
    def killed(self) -> int:
        return self.life.killed

    @property
    def drained_ok(self) -> int:
        return self.life.drained_ok

    @property
    def requeued(self) -> int:
        return self.life.requeued

    # ---- lifecycle hooks (static fleet: only the notice reaper) -------------
    def note_arrival(self) -> None:
        pass

    def serving(self) -> List[WorkerState]:
        return self.workers

    def active(self) -> List[WorkerState]:
        return self.workers

    def begin_beat(self, topo, t: float) -> None:
        if self.life.condemned:
            topo.requeue(self.life.reap(t, self._lookup))

    def end_beat(self, topo, t: float, t_next: float) -> None:
        pass

    def _lookup(self, wid: int) -> Optional[WorkerState]:
        return next((x for x in self.workers if x.id == wid), None)

    # ---- market reclaims ----------------------------------------------------
    def on_reclaim(self, t: float, ev) -> List[Request]:
        return self.life.reclaim(t, ev, self.life.eligible(self.workers))


class ColocatedTopology:
    """One colocated serving tier: queue -> placement (Algorithm 1 or a
    baseline) -> event-batched worker advance, over a pluggable worker
    container — ``FixedPool`` (fixed / elastic fleets) or
    ``forecast.ManagedPool`` (policy-driven boot/drain/bill lifecycle).
    The pluggable pool is what makes topology x scaling x market composable
    while every combination runs the same placement core and the same
    causal heartbeat loop."""

    def __init__(self, slo: SLO, cfg: SimConfig, pool, rng,
                 predictor: Optional[LengthPredictor] = None,
                 observer: Optional[Callable] = None, tracking: bool = True,
                 tenants: Optional[Sequence] = None):
        self.slo = slo
        self.cfg = cfg
        self.pool = pool
        self.rng = rng
        self.predictor = predictor
        self.observer = observer
        self.tracking = tracking       # Algorithm 2 repredict + rebalance
        self.tracker = ErrorTracker()
        self.queued: List[Request] = []
        self.finished: List[Request] = []
        self.moves = 0
        self.peak_workers = len(pool.serving())
        # multi-tenant serving: with >1 tenant the queue is ordered
        # priority-then-EDF before every placement pass; a single tenant
        # resolves to the legacy FIFO walk (bit-for-bit the scalar path).
        # ``restricted`` marks fleets where not every worker may serve
        # every request (dedicated pools / LoRA-capable workers) — it
        # filters placement candidates and disables cross-worker
        # rebalance moves (which do not re-check eligibility).
        self.tenants = list(tenants) if tenants is not None else None
        self.edf = self.tenants is not None and len(self.tenants) > 1
        self.restricted = False
        self.lora_swaps = 0
        self._lora: Dict[int, List[str]] = {}   # wid -> resident adapters
        # multi-turn sessions: the sticky session -> home-worker affinity
        # map and the shared cache tally (per-worker PrefixCaches are
        # installed lazily on each SimWorker; they die with their worker,
        # the tally must not). split_phase fleets never prefill, so a
        # prefill cache is meaningless there.
        if cfg.router not in ("blind", "sticky"):
            raise ValueError(f"unknown session router {cfg.router!r} "
                             "(expected 'blind' or 'sticky')")
        if cfg.prefix_cache not in ("lru", "off"):
            raise ValueError(f"unknown prefix_cache {cfg.prefix_cache!r} "
                             "(expected 'lru' or 'off')")
        self.cache_stats = CacheStats()
        self.session_home: Dict[int, int] = {}
        self._sticky = cfg.router == "sticky"
        self._caching = cfg.prefix_cache != "off" and not cfg.split_phase

    def admit(self, r: Request) -> None:
        r.l_pred = self.predictor.predict(r.l_in) if self.predictor \
            else r.l_real
        self.queued.append(r)
        self.pool.note_arrival()

    def requeue(self, reqs: List[Request], side: str = "serve") -> None:
        for r in reqs:
            r.cached_len = 0    # any granted prefix reuse is void off-worker
        self.queued.extend(reqs)

    def backlog_len(self, side: str = "serve") -> int:
        return len(self.queued)

    def slo_window(self, side: str, t_now: float, window: float,
                   metric: str = "both") -> tuple:
        """Windowed observed attainment for the SLO-feedback policies
        (``core.slo.windowed_attainment``); queued requests whose TTFT
        budget expired while waiting count as assured misses."""
        return windowed_attainment(self.finished, self.slo, t_now, window,
                                   metric, ttft_pending=self.queued)

    def fire(self, t: float, ev) -> None:
        self.requeue(self.pool.on_reclaim(t, ev))

    def _eligible(self, w: WorkerState, r: Request) -> bool:
        """Dedicated-pool / LoRA placement fence: a worker tagged with
        ``allowed_tenants`` only serves those tenants, and LoRA-tenant
        traffic needs a worker with adapter slots."""
        allowed = getattr(w, "allowed_tenants", None)
        if allowed is not None and r.tenant not in allowed:
            return False
        if self.tenants is not None \
                and self.tenants[r.tenant].lora is not None \
                and w.spec.lora_slots <= 0:
            return False
        return True

    def _lora_admit(self, w: WorkerState, r: Request, t: float) -> None:
        """Adapter residency accounting after a LoRA-tenant placement:
        fault the adapter in (LRU-evicting at ``lora_slots``), charge the
        worker's KV budget ``lora_overhead`` per resident adapter, and
        stall the worker ``lora_swap_s`` for the weight fetch (ongoing
        requests' ATGT clocks burn through the stall, like a prefill)."""
        adapter = self.tenants[r.tenant].lora if self.tenants else None
        if adapter is None:
            return
        res = self._lora.setdefault(w.id, [])
        if adapter in res:
            res.remove(adapter)
            res.append(adapter)         # LRU touch
            return
        spec = w.spec
        if len(res) >= spec.lora_slots:
            res.pop(0)
            w.cfg.kv_capacity += spec.lora_overhead
        res.append(adapter)
        w.cfg.kv_capacity -= spec.lora_overhead
        self.lora_swaps += 1
        if spec.lora_swap_s > 0.0:
            sim = self.pool.sims.get(w.id)
            if sim is not None:
                sim.t = max(sim.t, t) + spec.lora_swap_s
            for m in w.ongoing:
                m.t_decode_spent += spec.lora_swap_s

    def _cache(self, sim: SimWorker) -> Optional[PrefixCache]:
        if not self._caching:
            return None
        if sim.cache is None:
            sim.cache = PrefixCache(self.cache_stats,
                                    cap_tokens=self.cfg.cache_tokens)
        return sim.cache

    def _try_home(self, r: Request) -> Optional[WorkerState]:
        """Sticky routing: place the turn on its session's home worker —
        but only if the home is alive, not draining, eligible and passes
        every placement constraint *with the prefill discount its cache
        hit would buy*. An infeasible (or dead) home falls through to the
        configured placement policy like any other request."""
        wid = self.session_home.get(r.session_id)
        if wid is None:
            return None
        w = next((x for x in self.pool.serving() if x.id == wid), None)
        if w is None or not w.alive or w.draining:
            return None
        if self.restricted and not self._eligible(w, r):
            return None
        sim = self.pool.sims.get(wid)
        if sim is not None and sim.cache is not None:
            r.cached_len = sim.cache.peek(r.session_id, r.prefix_len)
        if w.feasible([r]):
            w.place(r)
            return w
        r.cached_len = 0        # discount only applies on the home worker
        return None

    def _place_one(self, r: Request) -> Optional[WorkerState]:
        workers = self.pool.serving()
        fac = self.pool.factory
        if self.restricted:
            # pass a filtered copy: restricted fleets are fixed-size, so
            # the factory append path is never taken on the copy
            workers = [w for w in workers if self._eligible(w, r)]
            fac = None
        if self.cfg.policy == "aladdin":
            return best_fit_place(workers, r, allow_new=fac is not None,
                                  new_worker_factory=fac)
        if self.cfg.policy == "jsq":
            return jsq_place(workers, r, allow_new=fac is not None,
                             new_worker_factory=fac)
        return power_of_two_place(workers, r, self.rng,
                                  allow_new=fac is not None,
                                  new_worker_factory=fac)

    def step(self, t: float, t_next: float, arrived: int) -> None:
        pool = self.pool
        pool.begin_beat(self, t)
        # re-prediction for underruns (Algorithm 2 inputs)
        if self.tracking and self.predictor:
            for w in pool.serving():
                for r in w.ongoing:
                    if r.l_out > r.l_pred and not r.repredicted:
                        self.tracker.on_underrun(
                            r, self.predictor.repredict(r.l_in, r.l_out))
                        w.mark_dirty()
        # placement — multi-tenant queues order priority-then-EDF first
        # (stable sort: equal keys keep FIFO/requeue order), so interactive
        # traffic places ahead of batch tier every beat while unplaced
        # requests simply stay queued (no starvation under bounded load:
        # every queued request is retried every beat)
        if self.edf:
            self.queued.sort(key=lambda r: (-r.priority, r.deadline))
        still: List[Request] = []
        for r in self.queued:
            w = self._try_home(r) if self._sticky and r.session_id >= 0 \
                else None
            if w is None:
                w = self._place_one(r)
            if w is None:
                still.append(r)
            else:
                r.state = ReqState.PLACED
                if w.id not in pool.sims:
                    pool.sims[w.id] = SimWorker(w, w.perf, t,
                                                self.cfg.split_phase)
                if r.session_id >= 0:
                    cache = self._cache(pool.sims[w.id])
                    # consume the session's entry on the chosen worker —
                    # a blind-router placement that happens to land on the
                    # cached worker gets the same discount sticky would
                    r.cached_len = cache.grant(r.session_id, r.prefix_len) \
                        if cache is not None else 0
                    if self._sticky:
                        self.session_home[r.session_id] = w.id
                if self.restricted:
                    self._lora_admit(w, r, t)
        self.queued = still
        if self.tracking and self.cfg.rebalance and not self.restricted \
                and self.cfg.policy == "aladdin":
            self.moves += rebalance(pool.serving(), self.tracker)
            self.tracker.decay()
        self.peak_workers = max(self.peak_workers, len(pool.serving()))
        # advance workers
        before = len(self.finished)
        for w in pool.active():
            pool.sims[w.id].advance_to(t_next, self.finished, t_start=t)
        if self.tracking:
            for r in self.finished[before:]:
                self.tracker.on_finish(r)
                if self.predictor:
                    self.predictor.observe(r.l_in, r.l_real)
        pool.end_beat(self, t, t_next)
        if self.observer is not None:
            self.observer(t=t_next, workers=pool.serving(), sims=pool.sims,
                          queued=self.queued, finished=self.finished,
                          arrived=arrived)

    def drained(self) -> bool:
        return (not self.queued
                and all(not w.ongoing and not w.new_batch
                        for w in self.pool.active())
                and all(not s.preempted for s in self.pool.sims.values()))


def simulate(trace: Sequence[Request], perf: PerfModel, slo: SLO,
             kv_capacity: float, cfg: SimConfig,
             n_workers: Optional[int] = None,
             predictor: Optional[LengthPredictor] = None,
             fleet: Optional[Sequence[WorkerSpec]] = None,
             observer: Optional[Callable] = None) -> SimResult:
    """Run the serving simulation.

    .. deprecated:: delegate to :func:`repro.serving.api.run` — this shim
       builds the equivalent declarative ``Scenario`` and reproduces the
       pre-Scenario metrics bit-for-bit (pinned by tests/test_shim_goldens).

    n_workers fixed (None = elastic: open a worker whenever placement fails,
    i.e. the min-cost oracle mode). ``fleet`` overrides the homogeneous
    (perf, kv_capacity) description with exactly one WorkerSpec per worker —
    a fixed (possibly heterogeneous) fleet; elastic mode requires fleet=None
    (sweep fleet sizes via min_workers_for_slo's fleet_fn instead).
    ``observer(t, workers, sims, queued, finished, arrived)`` is called at
    the end of every heartbeat (invariant checks in tests)."""
    from repro_torch.serving import api

    default_spec = WorkerSpec(perf=perf, kv_capacity=kv_capacity,
                              max_batch=cfg.max_batch)
    if fleet is not None:
        pools = [api.PoolSpec(spec, 1) for spec in fleet]
    else:
        pools = [api.PoolSpec(default_spec, int(n_workers or 0))]
    scenario = api.Scenario(
        workload=trace, fleet=api.FleetSpec(pools), slo=slo,
        topology=api.Colocated(heartbeat=cfg.heartbeat, policy=cfg.policy,
                               split_phase=cfg.split_phase,
                               rebalance=cfg.rebalance, gamma=cfg.gamma,
                               theta=cfg.theta, max_batch=cfg.max_batch),
        scaling=api.FixedScale(),
        predictor=predictor, observer=observer, seed=cfg.seed)
    return api.run(scenario).to_sim_result()


def min_workers_for_slo(trace_fn, perf: PerfModel, slo: SLO,
                        kv_capacity: float, cfg: SimConfig,
                        attain_target: float = 0.99, lo: int = 1,
                        hi: int = 512,
                        predictor: Optional[LengthPredictor] = None,
                        fleet_fn: Optional[Callable[[int],
                                                    Sequence[WorkerSpec]]]
                        = None) -> int:
    """Binary search the minimum fixed worker count attaining the SLO target
    (the paper's cost metric in Figs. 11/12). ``fleet_fn(n)`` maps a worker
    count to a (possibly heterogeneous) fleet — e.g. an A100/V100 mix at a
    fixed ratio; the default is n homogeneous (perf, kv_capacity) workers.

    .. deprecated:: delegate to :func:`repro.serving.api.optimize`, which
       subsumes this search (objective="cost" on a colocated scenario)."""
    from repro_torch.serving import api

    default_spec = WorkerSpec(perf=perf, kv_capacity=kv_capacity,
                              max_batch=cfg.max_batch)
    scenario = api.Scenario(
        workload=trace_fn,
        fleet=api.FleetSpec([api.PoolSpec(default_spec, 0)]), slo=slo,
        topology=api.Colocated(heartbeat=cfg.heartbeat, policy=cfg.policy,
                               split_phase=cfg.split_phase,
                               rebalance=cfg.rebalance, gamma=cfg.gamma,
                               theta=cfg.theta, max_batch=cfg.max_batch),
        scaling=api.FixedScale(), predictor=predictor, seed=cfg.seed)
    plan = api.optimize(scenario, objective="cost",
                        attain_target=attain_target, lo=lo, hi=hi,
                        fleet_fn=fleet_fn)
    return plan.n_workers
