"""End-to-end prefill/decode disaggregated cluster simulation.

The Splitwise/DistServe topology as a discrete-event model: *prefill pools*
admit arrivals under constraint (c) only (TTFT is the prefill pool's whole
job), finished prefills hand their KV cache to *decode pools* over an
interconnect with modeled bandwidth/latency, and the decode pools run the
split-phase variant of Algorithm 1 (constraints (b)/(e); no prefill ever
interferes with decode, which is the point of disaggregation).

Pools may be heterogeneous: ``simulate_disaggregated`` takes lists of
``(WorkerSpec, count)`` pool types on both sides (e.g. A100-TP4 next to
V100-TP8 prefill pools) and an SLO-aware router picks the pool per request.
The router score is prompt-length-affine (UELLM-style): the accelerator-cost
-weighted prefill latency ``gpu_cost * (k1*l_in + c1)`` — short prompts flow
to cheap pools, long prompts to pools whose fast prefill is worth the cost —
and a pool is only eligible when constraint (c) holds on some worker in it.
The legacy single ``(prefill_spec, decode_spec)`` arguments still work and
describe one pool type per side.

Both simulators share the causal-time heartbeat core
(``run_heartbeat_loop``): a request is admitted at the first heartbeat
boundary at-or-after its arrival, never before it, so colocated and
disaggregated TTFTs are measured under identical admission semantics.

``min_cost_disagg`` walks the joint (n_prefill, n_decode) frontier and
returns the cheapest configuration meeting the SLO target, directly
comparable with the colocated ``min_workers_for_slo`` cost on the same
trace; ``prefill_pool_fn`` / ``decode_pool_fn`` map a worker count to a
heterogeneous pool mix at a fixed ratio, while ``prefill_mix`` /
``decode_mix`` + ``ratio_grid`` make the pool-type ratio itself a search
dimension (the cheapest (ratio_p, ratio_d, n_p, n_d) point wins).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement import WorkerState, best_fit_place, jsq_place
from repro_torch.core.request import ReqState, Request
from repro_torch.core.slo import SLO, windowed_attainment
from repro_torch.core.worker_config import WorkerSpec
from repro_torch.serving.lifecycle import (WorkerLifecycle, mark_kv_loss,
                                     mark_requeue)

# One pool type: (worker spec, number of workers of that type).
Pool = Tuple[WorkerSpec, int]


@dataclasses.dataclass
class DisaggConfig:
    # Finer than the colocated 0.25 s default: the disaggregated pipeline
    # has TWO scheduler-quantized hops (arrival->prefill, handoff->decode),
    # and the handoff wait is charged against the tight ATGT budget. Real
    # systems admit handoffs at decode-iteration granularity (~tens of ms);
    # a coarse beat would bill scheduling quantization as SLO loss (the
    # seed hid it by starting decode before the KV had arrived).
    heartbeat: float = 0.05
    policy: str = "aladdin"            # decode-pool placement: aladdin | jsq
    gamma: float = 0.5
    theta: float = 0.9
    kv_transfer_bw: float = 64e9       # bytes/s prefill->decode interconnect
    kv_transfer_lat: float = 2e-3      # fixed per-handoff latency, s
    seed: int = 0
    # Prefill-pool routing. "packed" is the legacy Algorithm-1 bin order
    # (fullest feasible worker first) — it ignores the worker's *clock*, so
    # at high rates every tie routes to the first worker whose just-run
    # batch left pending_tokens == 0 while its clock sits a whole batch
    # ahead, a scale-invariant TTFT tail the deprecation shims must keep
    # reproducing. "earliest" ranks by estimated completion (clock backlog
    # + queued + candidate prefill) and admits only when that estimate
    # meets the TTFT budget — what the autoscaled disaggregated scenarios
    # use, since it makes added capacity actually absorb the tail.
    prefill_router: str = "packed"     # packed | earliest
    # Decode-pool placement order. "packed" is Algorithm 1's bin order
    # (fullest feasible worker first) — like the packed prefill router it
    # is blind to the worker's *clock*, so a worker whose just-run batch
    # left it top-ranked keeps absorbing ties while its event-batched
    # clock sits a whole decode segment past the beat; every request
    # placed there stalls that long before its next token, an ATGT tail
    # that does not shrink with pool size. "earliest" ranks feasible
    # workers by clock backlog first (then the affine routing score, then
    # Algorithm 1's packing), mirroring the wait-aware prefill router.
    decode_router: str = "packed"      # packed | earliest


def prefill_affinity(spec: WorkerSpec, l_in: int) -> float:
    """UELLM-style prompt-length-affine routing score (lower = preferred):
    accelerator-cost-weighted prefill latency a + b*l_in of this prompt on
    the pool type."""
    p = spec.perf.prefill
    return spec.gpu_cost * (p.k1 * l_in + p.c1)


def decode_affinity(spec: WorkerSpec, r: Request, gamma: float) -> float:
    """Decode-side analogue, affine in the predicted context: cost-weighted
    marginal decode time of carrying (l_in + gamma*l_pred) KV tokens."""
    d = spec.perf.decode
    return spec.gpu_cost * (d.k2 * (r.l_in + gamma * r.l_pred) + d.c2)


class PrefillSimWorker:
    """One prefill-pool worker: a clock and a queue of admitted prompts.

    Admission is constraint (c) alone — the pending prompt tokens plus the
    candidate must prefill within the TTFT budget (Eq. 2). Queued prompts are
    batched once per heartbeat, exactly like the colocated simulator's
    prefill iterations.

    All token accounting is in ``r.context`` (= l_in + l_out) rather than
    ``l_in``: identical for a fresh request (l_out == 0 until prefill stamps
    its first token), but a spot-reclaim re-entrant from a dead decode
    worker re-prefills its prompt AND the tokens generated so far — the
    KV-loss recovery cost the asymmetric-hazard scenarios measure."""

    def __init__(self, wid: int, spec: WorkerSpec, slo: SLO):
        self.id = wid
        self.spec = spec
        self.perf = spec.perf
        self.slo = slo
        self.t = 0.0
        self.queue: List[Request] = []
        self.pending_tokens = 0
        self.iters = 0
        self.draining = False          # notice window / scale-down drain

    def feasible(self, r: Request) -> bool:
        return float(self.perf.prefill(self.pending_tokens + r.context)) \
            <= self.slo.ttft

    def place(self, r: Request) -> None:
        r.worker = self.id
        r.state = ReqState.PLACED
        self.queue.append(r)
        self.pending_tokens += r.context

    def advance_to(self, t_end: float, t_start: float,
                   done: List[Tuple[Request, float]]) -> None:
        """Run whole-queue prefill batches until the clock passes ``t_end``;
        ``done`` collects ``(request, completion_time)`` pairs. The explicit
        completion time matters for decode-reclaim re-entrants: their
        ``t_first_token`` is the *original* pre-reclaim stamp, so the KV
        re-transfer must be anchored to when this re-prefill actually
        finished (for fresh requests the two are the same instant)."""
        if self.queue:
            self.t = max(self.t, t_start)
        while self.queue and self.t < t_end:
            batch, self.queue = self.queue, []
            dur = float(self.perf.prefill(sum(r.context for r in batch)))
            self.t += dur
            self.iters += 1
            for r in batch:
                self.pending_tokens -= r.context
                if r.t_first_token is None:
                    r.t_first_token = self.t   # first token is prefill's
                    r.l_out = 1
                done.append((r, self.t))
        if not self.queue:
            self.t = max(self.t, t_end)


@dataclasses.dataclass
class DisaggResult:
    n_prefill: int
    n_decode: int
    gpu_cost: float
    attainment: float
    p99_ttft: float
    p99_atgt: float
    mean_transfer: float               # mean KV-handoff time, s
    finished: int
    total: int
    pool_mix: str = ""                 # e.g. "p:a100-tp4x2|d:a100-tp4x4"

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def _as_pools(spec: Optional[WorkerSpec], n: int,
              pools: Optional[Sequence[Pool]]) -> List[Pool]:
    if pools is not None:
        out = [(s, int(k)) for s, k in pools if k > 0]
        if not out:
            raise ValueError("pool list contains no workers")
        return out
    if spec is None:
        raise ValueError("pass either a spec+count or a pool list")
    if n <= 0:
        raise ValueError(f"worker count must be positive, got {n}")
    return [(spec, int(n))]


def pool_cost(pools: Sequence[Pool]) -> float:
    return sum(k * s.gpu_cost for s, k in pools)


def _mix_label(prefill_pools: Sequence[Pool],
               decode_pools: Sequence[Pool]) -> str:
    p = ",".join(f"{s.name}x{k}" for s, k in prefill_pools)
    d = ",".join(f"{s.name}x{k}" for s, k in decode_pools)
    return f"p:{p}|d:{d}"


# ---- topology sides ----------------------------------------------------------
# A "side" is one half of the disaggregated pipeline: its worker groups (for
# the affine router), a lifecycle (static or ManagedPool-scaled), and the
# market-reclaim handler. The topology below drives either kind through the
# same step sequence.

class _FixedSide:
    """Shared shell of the two static disaggregated sides: routed worker
    groups plus the one :class:`WorkerLifecycle` reclaim machine. Subclasses
    supply only the lost-request extraction, the idle test and the recovery
    marking — the whole condemn/kill/reap flow is the shared helper's."""

    side = "prefill"

    def __init__(self, pools: List[Tuple[WorkerSpec, List]],
                 rng=None, notice_s: float = 0.0):
        self.pools = pools
        self.gpu_s = 0.0
        self.spot_gpu_s = 0.0
        self.epochs: List = []
        self.life = WorkerLifecycle(
            rng, notice_s=notice_s, extract=self._extract, mark=self._mark,
            idle=self._is_idle, remove=self._remove,
            on_condemn=lambda w: setattr(w, "draining", True))

    def groups(self):
        return self.pools

    def active(self) -> List:
        return [w for _, g in self.pools for w in g]

    def note_arrival(self) -> None:
        pass

    def begin_beat(self, topo, t: float) -> None:
        if self.life.condemned:
            topo.requeue(self.life.reap(t, self._lookup), side=self.side)

    def end_beat(self, topo, t: float, t_next: float) -> None:
        pass

    def on_reclaim(self, t: float, ev) -> List[Request]:
        return self.life.reclaim(t, ev, self.life.eligible(self.active()))

    @property
    def killed(self) -> int:
        return self.life.killed

    @property
    def drained_ok(self) -> int:
        return self.life.drained_ok

    @property
    def requeued(self) -> int:
        return self.life.requeued

    # ---- WorkerLifecycle adapters -------------------------------------------
    def _lookup(self, wid: int):
        return next((x for x in self.active() if x.id == wid), None)

    def _remove(self, w) -> None:
        for _, g in self.pools:
            if w in g:
                g.remove(w)
                break


class FixedPrefillSide(_FixedSide):
    """Static prefill pool groups. A spot market may reclaim spot workers
    out of the fixed pool (not replaced): instant kill requeues the queued
    prompts (nearly free — no KV existed), a notice window drains first."""

    side = "prefill"
    _mark = staticmethod(mark_requeue)

    def _extract(self, w: PrefillSimWorker) -> List[Request]:
        lost = list(w.queue)
        w.queue.clear()
        w.pending_tokens = 0
        return lost

    def _is_idle(self, w: PrefillSimWorker) -> bool:
        return not w.queue


class FixedDecodeSide(_FixedSide):
    """Static decode pool groups (split-phase WorkerStates + SimWorkers).
    Market reclaims lose the victims' KV: requests requeue to the *prefill*
    queue and pay a full context re-prefill plus the KV re-transfer."""

    side = "decode"
    _mark = staticmethod(mark_kv_loss)

    def __init__(self, pools: List[Tuple[WorkerSpec, List]],
                 sims: Dict, rng=None, notice_s: float = 0.0):
        super().__init__(pools, rng=rng, notice_s=notice_s)
        self.sims = sims

    def _extract(self, w) -> List[Request]:
        sim = self.sims.get(w.id)
        lost = w.ongoing + w.new_batch + (sim.preempted if sim else [])
        w.ongoing.clear()
        w.new_batch.clear()
        w.mark_dirty()
        return lost

    def _is_idle(self, w) -> bool:
        sim = self.sims.get(w.id)
        return not w.ongoing and not w.new_batch \
            and not (sim and sim.preempted)

    def _remove(self, w) -> None:
        super()._remove(w)
        self.sims.pop(w.id, None)


class ManagedSide:
    """Adapter presenting a ``forecast.ManagedPool`` as one routed pool
    group of a disaggregated side — the autoscaled half of the disagg x
    scaling x spot matrix."""

    def __init__(self, pool, spec: WorkerSpec):
        self.pool = pool
        self.spec = spec
        self.sims = pool.sims

    def groups(self):
        return [(self.spec, self.pool.online)]

    def active(self) -> List:
        return self.pool.active()

    def note_arrival(self) -> None:
        self.pool.note_arrival()

    def begin_beat(self, topo, t: float) -> None:
        self.pool.begin_beat(topo, t)

    def end_beat(self, topo, t: float, t_next: float) -> None:
        self.pool.end_beat(topo, t, t_next)

    def on_reclaim(self, t: float, ev) -> List[Request]:
        return self.pool.on_reclaim(t, ev)

    @property
    def killed(self):
        return self.pool.killed

    @property
    def drained_ok(self):
        return self.pool.drained_ok

    @property
    def requeued(self):
        return self.pool.requeued

    @property
    def gpu_s(self):
        return self.pool.gpu_s

    @property
    def spot_gpu_s(self):
        return self.pool.spot_gpu_s

    @property
    def epochs(self):
        return self.pool.epochs


class DisaggTopology:
    """Prefill pools -> modeled KV transfer -> decode pools, over pluggable
    sides (static groups or ManagedPool-scaled), driven beat-by-beat by the
    shared causal heartbeat loop."""

    def __init__(self, slo: SLO, cfg: DisaggConfig, prefill, decode, rng,
                 predictor=None, observer: Optional[Callable] = None):
        self.slo = slo
        self.cfg = cfg
        self.prefill = prefill
        self.decode = decode
        self.rng = rng
        self.predictor = predictor
        self.observer = observer
        self.queued_p: List[Request] = []    # waiting for prefill admission
        self.in_transfer: List[Tuple[float, Request]] = []
        self.queued_d: List[Request] = []    # KV arrived, awaiting decode
        self.finished: List[Request] = []
        self.transfers: List[float] = []
        self.kv_retransfers = 0              # re-entrant KV re-transfers
        self._now = 0.0                      # beat start (earliest router)

    def admit(self, r: Request) -> None:
        r.l_pred = self.predictor.predict(r.l_in) if self.predictor \
            else r.l_real
        self.queued_p.append(r)
        self.prefill.note_arrival()
        self.decode.note_arrival()

    def requeue(self, reqs: List[Request], side: str = "prefill") -> None:
        # both sides' reclaim victims re-enter at the prefill queue: a
        # decode victim lost its KV (full re-prefill + re-transfer), a
        # prefill victim simply waits for another slot
        self.queued_p.extend(reqs)

    def backlog_len(self, side: str) -> int:
        return len(self.queued_p) if side == "prefill" \
            else len(self.queued_d)

    def slo_window(self, side: str, t_now: float, window: float,
                   metric: str = "both") -> Tuple[int, int]:
        """Windowed observed attainment for the SLO-feedback policies
        (``core.slo.windowed_attainment``: ``ttft`` for the prefill side,
        ``atgt`` for decode; TTFT-expired waiting prompts are assured
        misses), plus the decode queue's own assured misses — a handed-off
        request whose decode-queue stall alone already burned the whole
        per-token budget of its predicted stream."""
        ok, total = windowed_attainment(self.finished, self.slo, t_now,
                                        window, metric,
                                        ttft_pending=self.queued_p)
        if metric != "ttft":
            for r in self.queued_d:
                if r.t_first_token is not None \
                        and t_now - r.t_first_token \
                        > self.slo.atgt * max(r.l_pred - 1, 1):
                    total += 1
        return ok, total

    def fire(self, t: float, ev) -> None:
        side = self.decode if getattr(ev, "side", "decode") == "decode" \
            else self.prefill
        self.requeue(side.on_reclaim(t, getattr(ev, "ev", ev)))

    def place_prefill(self, r: Request) -> Optional[PrefillSimWorker]:
        if self.cfg.prefill_router == "earliest":
            w = self._place_prefill_earliest(r)
        else:
            w = self._place_prefill_packed(r)
        if w is None and r.l_out > 0:
            # decode-reclaim re-entrant: its TTFT is already history, so the
            # fresh-arrival admission budget cannot apply — a grown context
            # that no longer prefills inside slo.ttft would otherwise be
            # stranded in queued_p until the horizon. Recovery is
            # best-effort: take the least-loaded worker and bill the stall
            # against ATGT like every other recovery cost.
            w = self._place_prefill_fallback(r)
        return w

    def _place_prefill_packed(self, r: Request) -> \
            Optional[PrefillSimWorker]:
        # rank pool types by the affine routing score, then best-fit within
        # the pool (fullest feasible worker first, Algorithm 1's bin order);
        # fall through to the next pool when nothing in this one is feasible
        for spec, group in sorted(self.prefill.groups(),
                                  key=lambda p: prefill_affinity(p[0],
                                                                 r.l_in)):
            ranked = sorted((w for w in group if not w.draining),
                            key=lambda w: w.pending_tokens, reverse=True)
            for w in ranked:
                if w.feasible(r):
                    w.place(r)
                    return w
        return None

    def _place_prefill_fallback(self, r: Request) -> \
            Optional[PrefillSimWorker]:
        best, _ = self._earliest_scan(r)
        if best is not None:
            best.place(r)
        return best

    def _earliest_scan(self, r: Request) -> \
            Tuple[Optional[PrefillSimWorker], float]:
        """The worker with the earliest estimated completion for this
        prompt — clock backlog past 'now' plus the prefill of
        (pending + candidate) tokens — and that estimate."""
        now = self._now
        best = None
        best_done = float("inf")
        for spec, group in self.prefill.groups():
            for w in group:
                if w.draining:
                    continue
                backlog = max(w.t - now, 0.0)
                done = backlog + float(w.perf.prefill(w.pending_tokens
                                                      + r.context))
                if done < best_done:
                    best, best_done = w, done
        return best, best_done

    def _place_prefill_earliest(self, r: Request) -> \
            Optional[PrefillSimWorker]:
        """Wait-aware prefill routing: admit on the earliest-completion
        worker if its estimate still meets the TTFT budget. Unlike the
        legacy packed order this sees a worker whose just-run batch left
        it 'empty' but whose clock overshot the beat, so ties spread
        instead of piling onto one bin."""
        best, best_done = self._earliest_scan(r)
        if best is not None and best_done <= self.slo.ttft:
            best.place(r)
            return best
        return None

    def place_decode(self, r: Request) -> Optional[WorkerState]:
        if self.cfg.decode_router == "earliest":
            return self._place_decode_earliest(r)
        for spec, group in sorted(self.decode.groups(),
                                  key=lambda p: decode_affinity(
                                      p[0], r, self.cfg.gamma)):
            if self.cfg.policy == "aladdin":
                w = best_fit_place(group, r, allow_new=False)
            else:
                w = jsq_place(group, r, allow_new=False)
            if w is not None:
                return w
        return None

    def _place_decode_earliest(self, r: Request) -> Optional[WorkerState]:
        """Wait-aware decode placement mirroring the 'earliest' prefill
        router: rank candidates by how far the worker's event-batched clock
        overshot this beat (the stall every new placement inherits before
        its next token), then by the affine pool score, then by Algorithm
        1's packing order — and take the first constraint-feasible one.
        Unlike the packed order this never keeps piling ties onto a bin
        whose clock sits a whole decode segment ahead, so the packed
        router's scale-invariant ATGT tie-pile tail disappears
        (tests/test_decode_router.py pins it)."""
        now = self._now
        sims = self.decode.sims
        ranked = []
        for spec, group in self.decode.groups():
            aff = decode_affinity(spec, r, self.cfg.gamma)
            for w in group:
                if not w.alive or w.draining:
                    continue
                sim = sims.get(w.id)
                backlog = max(sim.t - now, 0.0) if sim is not None else 0.0
                ranked.append((backlog, aff, -w.capacity_norm(), w.id, w))
        ranked.sort(key=lambda e: e[:4])
        for _, _, _, _, w in ranked:
            ok = w.feasible([r]) if self.cfg.policy == "aladdin" \
                else w._admit_naive([r])
            if ok:
                w.place(r)
                return w
        return None

    def step(self, t: float, t_next: float, arrived: int) -> None:
        cfg = self.cfg
        self._now = t
        self.prefill.begin_beat(self, t)
        self.decode.begin_beat(self, t)
        # prefill placement: constraint (c) only, router picks the pool
        still: List[Request] = []
        for r in self.queued_p:
            if self.place_prefill(r) is None:
                still.append(r)
        self.queued_p = still
        # advance the prefill pools; completed prefills enter KV transfer.
        # A re-entrant (t_preempted armed: its decode worker was reclaimed)
        # moves its whole context — prompt plus generated tokens — through
        # the interconnect again; that is the KV re-transfer the asymmetric
        # spot hazards price in.
        for w in self.prefill.active():
            done: List[Tuple[Request, float]] = []
            w.advance_to(t_next, t, done)
            for r, t_done in done:
                retransfer = r.t_preempted is not None
                tok = r.l_in + r.l_out if retransfer else r.l_in
                dt = cfg.kv_transfer_lat \
                    + tok * w.spec.kv_bytes_per_token \
                    / max(cfg.kv_transfer_bw, 1.0)
                self.transfers.append(dt)
                if retransfer:
                    self.kv_retransfers += 1
                # anchor the transfer to the actual prefill completion: for
                # a fresh request t_done == t_first_token (bit-for-bit with
                # the legacy max(t_first_token, t)), for a re-entrant the
                # stale first-token stamp would let the re-transfer start a
                # whole re-prefill early
                self.in_transfer.append((max(t_done, t) + dt, r))
        # KV handoffs completed by this boundary join the decode queue —
        # causally: a handoff ready inside (t, t_next) must wait for the
        # next boundary, else its decode would start before the KV arrived
        self.in_transfer.sort(key=lambda e: e[0])
        while self.in_transfer and self.in_transfer[0][0] <= t:
            self.queued_d.append(self.in_transfer.pop(0)[1])
        # decode placement: split-phase constraints (b)/(e), router-ordered
        still = []
        for r in self.queued_d:
            w = self.place_decode(r)
            if w is None:
                still.append(r)
            else:
                r.state = ReqState.PLACED
        self.queued_d = still
        for w in self.decode.active():
            self.decode.sims[w.id].advance_to(t_next, self.finished,
                                              t_start=t)
        self.prefill.end_beat(self, t, t_next)
        self.decode.end_beat(self, t, t_next)
        if self.observer is not None:
            self.observer(t=t_next, pool_p=self.prefill.active(),
                          states_d=self.decode.active(),
                          queued_p=self.queued_p,
                          in_transfer=self.in_transfer,
                          queued_d=self.queued_d, finished=self.finished,
                          arrived=arrived)

    def drained(self) -> bool:
        return (not self.queued_p and not self.queued_d
                and not self.in_transfer
                and all(not w.queue for w in self.prefill.active())
                and all(not w.ongoing and not w.new_batch
                        for w in self.decode.active())
                and all(not s.preempted
                        for s in self.decode.sims.values()))


def simulate_disaggregated(trace: Sequence[Request], slo: SLO,
                           cfg: DisaggConfig,
                           prefill_spec: Optional[WorkerSpec] = None,
                           decode_spec: Optional[WorkerSpec] = None,
                           n_prefill: int = 0, n_decode: int = 0,
                           predictor=None,
                           observer: Optional[Callable] = None,
                           prefill_pools: Optional[Sequence[Pool]] = None,
                           decode_pools: Optional[Sequence[Pool]] = None
                           ) -> DisaggResult:
    """Simulate ``trace`` on a disaggregated cluster.

    Homogeneous form: ``(prefill_spec, decode_spec, n_prefill, n_decode)``.
    Heterogeneous form: ``prefill_pools`` / ``decode_pools`` as lists of
    ``(WorkerSpec, count)``; the affine router picks the pool per request,
    falling through to the next-ranked pool when no worker is feasible.

    .. deprecated:: delegate to :func:`repro.serving.api.run` — this shim
       builds the equivalent declarative ``Scenario`` and reproduces the
       pre-Scenario metrics bit-for-bit (pinned by tests/test_shim_goldens).
    """
    from repro_torch.serving import api

    p_pools = _as_pools(prefill_spec, n_prefill, prefill_pools)
    d_pools = _as_pools(decode_spec, n_decode, decode_pools)
    pools = [api.PoolSpec(s, k, role="prefill") for s, k in p_pools] \
        + [api.PoolSpec(s, k, role="decode") for s, k in d_pools]
    scenario = api.Scenario(
        workload=trace, fleet=api.FleetSpec(pools), slo=slo,
        topology=api.Disaggregated(heartbeat=cfg.heartbeat, policy=cfg.policy,
                                   gamma=cfg.gamma, theta=cfg.theta,
                                   kv_transfer_bw=cfg.kv_transfer_bw,
                                   kv_transfer_lat=cfg.kv_transfer_lat,
                                   prefill_router=cfg.prefill_router,
                                   decode_router=cfg.decode_router),
        scaling=api.FixedScale(), predictor=predictor, observer=observer,
        seed=cfg.seed)
    return api.run(scenario).to_disagg_result()


def ratio_pool_fn(specs: Sequence[WorkerSpec],
                  ratio: float) -> Callable[[int], List[Pool]]:
    """Map a worker count n to a two-type (spec, count) mix at a fixed
    ratio: ``round(n * ratio)`` workers of ``specs[0]``, the rest of
    ``specs[1]`` (a single spec ignores the ratio). Rounding keeps both
    per-type counts — hence the pool cost — monotone in n, which the
    ``min_cost_disagg`` frontier prune requires."""
    if len(specs) == 1:
        return lambda n: [(specs[0], n)]
    if len(specs) != 2:
        raise ValueError("ratio mixes support exactly 1 or 2 worker types")
    a, b = specs
    r = min(max(ratio, 0.0), 1.0)

    def fn(n: int) -> List[Pool]:
        na = int(round(n * r))
        return [(s, k) for s, k in ((a, na), (b, n - na)) if k > 0]

    return fn


def min_cost_disagg(trace_fn, slo: SLO, cfg: DisaggConfig,
                    prefill_spec: Optional[WorkerSpec] = None,
                    decode_spec: Optional[WorkerSpec] = None,
                    attain_target: float = 0.99,
                    max_prefill: int = 8, hi_decode: int = 64,
                    predictor=None,
                    prefill_pool_fn: Optional[Callable[[int],
                                                       Sequence[Pool]]]
                    = None,
                    decode_pool_fn: Optional[Callable[[int],
                                                      Sequence[Pool]]]
                    = None,
                    prefill_mix: Optional[Sequence[WorkerSpec]] = None,
                    decode_mix: Optional[Sequence[WorkerSpec]] = None,
                    ratio_grid: Sequence[float] = (0.0, 0.25, 0.5,
                                                   0.75, 1.0)
                    ) -> Optional[DisaggResult]:
    """Walk the joint (n_prefill, n_decode) frontier: for each prefill-pool
    size, binary-search the minimum decode pool meeting the target, and keep
    the cheapest feasible point. Returns None if nothing within the bounds
    attains the target.

    ``prefill_pool_fn(n)`` / ``decode_pool_fn(n)`` map a worker count to a
    heterogeneous (spec, count) mix at a ratio the caller fixed; they must
    be monotone (cost non-decreasing in n) for the frontier prune to stay
    exact. The default is n homogeneous workers of the given spec.

    ``prefill_mix`` / ``decode_mix`` (each one or two ``WorkerSpec``) search
    the pool-type *ratio* jointly instead of fixing it: every ratio in
    ``ratio_grid`` (share of the first spec) is frontier-walked on both
    sides, sharing one best-so-far cost bound so expensive ratios are pruned
    before their first simulation where possible.

    .. deprecated:: delegate to :func:`repro.serving.api.optimize`, which
       subsumes this frontier walk (objective="cost" on a disaggregated
       scenario)."""
    from repro_torch.serving import api

    scenario = api.Scenario(
        workload=trace_fn,
        fleet=api.FleetSpec(
            [api.PoolSpec(prefill_spec, 0, role="prefill"),
             api.PoolSpec(decode_spec, 0, role="decode")]
            if prefill_spec is not None and decode_spec is not None else []),
        slo=slo,
        topology=api.Disaggregated(heartbeat=cfg.heartbeat, policy=cfg.policy,
                                   gamma=cfg.gamma, theta=cfg.theta,
                                   kv_transfer_bw=cfg.kv_transfer_bw,
                                   kv_transfer_lat=cfg.kv_transfer_lat,
                                   prefill_router=cfg.prefill_router,
                                   decode_router=cfg.decode_router),
        scaling=api.FixedScale(), predictor=predictor, seed=cfg.seed)
    plan = api.optimize(scenario, objective="cost",
                        attain_target=attain_target,
                        max_prefill=max_prefill, hi_decode=hi_decode,
                        prefill_pool_fn=prefill_pool_fn,
                        decode_pool_fn=decode_pool_fn,
                        prefill_mix=prefill_mix, decode_mix=decode_mix,
                        ratio_grid=ratio_grid)
    return plan.disagg_result
