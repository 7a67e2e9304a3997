"""Forecast-aware worker-count scaling (SageServe-style predictive scaling).

The reactive Eq. 7 scaler only reacts: it observes the arrival rate of the
*last* epoch, so with a non-zero provisioning delay every diurnal ramp is
served late (SLO misses on the ascent) and every decline is served long
(GPU-seconds wasted on the descent, where a reactive policy must hold a
scale-down cooldown because it cannot know demand is really falling).

This module adds the look-ahead half of the paper's §5.2 story:

  * ``SeasonalNaiveForecaster`` — demand forecast = the rate observed at the
    same phase one period ago (seasonal-naive) plus an EWMA of the recent
    residuals (level correction for traffic growth/decay). Any object with
    ``observe(t, rate)`` / ``forecast(t, lead)`` plugs in; ``EWMAForecaster``
    is the trivial non-seasonal baseline.
  * ``ReactivePolicy`` / ``ForecastPolicy`` — epoch scaling policies. Both
    feed the Eq. 7 fit; the forecast policy asks the forecaster for the rate
    ``provision_delay + epoch`` ahead, so workers are booted *before* the
    ramp needs them, and it keeps a per-phase floor of the worker count each
    phase bin has historically needed (never provision fewer workers at a
    ramp peak than the same phase needed one period earlier).
  * ``simulate_autoscaled`` — the colocated simulator with a worker
    lifecycle (boot delay, draining, retirement) driven by a policy, built
    on the same causal-time heartbeat core; reports GPU-seconds actually
    billed, which is what the cost comparison in the benchmarks uses.
  * ``SpotMarket`` — a preemptible capacity pool next to the on-demand one:
    a spot ``WorkerSpec`` (discounted price, reclaim hazard) plus a
    ``workload.preemption_trace`` of market reclaim events. The simulator
    kills spot workers when an event lands — their in-flight requests lose
    KV and re-enter the queue, paying a full re-prefill (prompt + generated
    tokens) plus the stall, both charged against TTFT/ATGT — and bills every
    worker at its own price class. ``ForecastPolicy`` (given a
    ``core.scaling.SpotMixConfig``) splits each epoch's capacity target into
    an (on-demand, spot) mix: the diurnal trough is served from reliable
    capacity, the swing from discounted-but-mortal spot, inflated by the
    hazard so expected surviving capacity still covers the target.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.request import Request
from repro_torch.core.scaling import (AttainmentController, Autoscaler,
                                AutoscalerConfig, FeedbackConfig,
                                SpotMixConfig, split_spot_mix)
from repro_torch.core.slo import SLO
from repro_torch.core.worker_config import WorkerSpec
from repro_torch.serving.lifecycle import (WorkerLifecycle,          # noqa: F401
                                     mark_kv_loss, mark_requeue)
from repro_torch.serving.simulator import SimConfig
from repro_torch.serving.workload import PreemptionEvent


# ---- forecasters -------------------------------------------------------------

@dataclasses.dataclass
class ForecastConfig:
    period: float = 300.0       # seasonal period, s (one diurnal cycle)
    bin_width: float = 5.0      # phase-bin resolution, s
    ewma_alpha: float = 0.3     # residual / level smoothing


class SeasonalNaiveForecaster:
    """Seasonal-naive + EWMA-residual demand forecaster.

    ``forecast(t, lead)`` returns the rate last observed at phase
    ``(t + lead) mod period`` plus the EWMA of recent (observed - seasonal)
    residuals; before a phase has been seen once, it falls back to the EWMA
    level of the rate itself (cold start = the reactive estimate)."""

    def __init__(self, cfg: ForecastConfig = ForecastConfig()):
        self.cfg = cfg
        self.n_bins = max(int(round(cfg.period / cfg.bin_width)), 1)
        self.seasonal: List[float] = [float("nan")] * self.n_bins
        self.resid = 0.0
        self.level: Optional[float] = None

    def _bin(self, t: float) -> int:
        return int(t / self.cfg.bin_width) % self.n_bins

    def observe(self, t: float, rate: float) -> None:
        a = self.cfg.ewma_alpha
        b = self._bin(t)
        prev = self.seasonal[b]
        if not math.isnan(prev):
            self.resid = a * (rate - prev) + (1 - a) * self.resid
        self.level = rate if self.level is None \
            else a * rate + (1 - a) * self.level
        self.seasonal[b] = rate

    def forecast(self, t: float, lead: float = 0.0) -> float:
        s = self.seasonal[self._bin(t + lead)]
        if math.isnan(s):
            return self.level if self.level is not None else 0.0
        return max(s + self.resid, 0.0)


class EWMAForecaster:
    """Non-seasonal baseline: the forecast at any lead is the EWMA level."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.level: Optional[float] = None

    def observe(self, t: float, rate: float) -> None:
        self.level = rate if self.level is None \
            else self.alpha * rate + (1 - self.alpha) * self.level

    def forecast(self, t: float, lead: float = 0.0) -> float:
        return self.level if self.level is not None else 0.0


# ---- scaling policies --------------------------------------------------------

@dataclasses.dataclass
class ScaleSimConfig:
    interval: float = 5.0            # scaling-epoch length, s
    provision_delay: float = 10.0    # boot time before a new worker serves
    cooldown: float = 60.0           # reactive scale-down stabilization, s
    lead: Optional[float] = None     # forecast look-ahead; None = delay+epoch
    min_workers: int = 1
    max_workers: int = 512
    initial_workers: int = 1
    # SLO head-room on every epoch target (kube-HPA-style utilization < 1):
    # a disaggregated pipeline needs it because per-side queue pressure
    # under-measures SLO pressure — TTFT burns in the arrival->prefill hop
    # and ATGT in the handoff->decode hop before any placement fails.
    headroom: float = 1.0


class ReactivePolicy:
    """Eq. 7 on the last observed rate + change-point boost + a scale-down
    cooldown (the kube-HPA-style stabilization window a reactive scaler
    needs to avoid flapping, and the GPU-seconds it pays on every descent)."""

    name = "reactive"

    def __init__(self, scfg: ScaleSimConfig,
                 autoscaler: Optional[Autoscaler] = None,
                 spot_mix: Optional[SpotMixConfig] = None):
        self.scfg = scfg
        self.autoscaler = autoscaler or Autoscaler(AutoscalerConfig(
            heartbeat=scfg.interval, min_workers=scfg.min_workers,
            max_workers=scfg.max_workers))
        self._recent: List[tuple] = []      # (t, raw target) inside cooldown
        # same exposure-horizon derivation as ForecastPolicy (policy-local
        # copy; the caller's config object is never mutated)
        self.spot_mix = None if spot_mix is None else dataclasses.replace(
            spot_mix, horizon=scfg.provision_delay + scfg.interval)

    def target(self, t: float, rate: float, needed: int,
               queued: int) -> int:
        sc = self.autoscaler
        sc.observe(rate, needed)
        tgt = sc.predict_workers(rate, last_needed=needed)
        if sc.change_point():
            tgt = max(tgt, needed)
        self._recent.append((t, tgt))
        self._recent = [x for x in self._recent
                        if x[0] >= t - self.scfg.cooldown]
        return max(tg for _, tg in self._recent)

    def split(self, t: float, target: int) -> Tuple[int, int]:
        """Price-class split: pure ``split_spot_mix`` economics (a reactive
        policy has no seasonal trough to pin on-demand). Without a mix the
        split is all-on-demand, which keeps the pre-spot behavior."""
        if self.spot_mix is None:
            return target, 0
        return split_spot_mix(target, self.spot_mix)


class ForecastPolicy:
    """Eq. 7 on the *forecast* rate ``lead`` seconds ahead, plus a per-phase
    floor of the worker count that phase has historically needed.  No
    cooldown: the forecaster itself says when demand is really falling, so
    the policy sheds workers on the descent instead of holding them.

    With a ``SpotMixConfig`` the policy also owns the price-class decision:
    ``split(t, target)`` carves each epoch's capacity target into an
    (on-demand, spot) pair — the historical diurnal *trough* (capacity some
    phase always needs) stays on reliable on-demand workers, the
    forecast-driven swing above it rides discounted spot, inflated by the
    reclaim hazard so the expected surviving capacity still covers the
    target (``core.scaling.split_spot_mix``)."""

    name = "forecast"

    def __init__(self, scfg: ScaleSimConfig, forecaster,
                 autoscaler: Optional[Autoscaler] = None,
                 spot_mix: Optional[SpotMixConfig] = None):
        self.scfg = scfg
        self.forecaster = forecaster
        self.autoscaler = autoscaler or Autoscaler(AutoscalerConfig(
            heartbeat=scfg.interval, min_workers=scfg.min_workers,
            max_workers=scfg.max_workers))
        # exposure horizon = how long a loss stays unreplaced: one epoch to
        # notice it plus the boot delay of the replacement (a policy-local
        # copy — the caller's config object is never mutated)
        self.spot_mix = None if spot_mix is None else dataclasses.replace(
            spot_mix, horizon=scfg.provision_delay + scfg.interval)
        # phase bin -> max workers that phase has needed (seasonal floor);
        # a forecaster without phase bins degrades to one global bin
        self._bin: Callable[[float], int] = getattr(forecaster, "_bin",
                                                    lambda t: 0)
        self._season_needed: Dict[int, int] = {}

    @property
    def lead(self) -> float:
        return self.scfg.lead if self.scfg.lead is not None \
            else self.scfg.provision_delay + self.scfg.interval

    def _leads(self) -> List[float]:
        # sample the whole look-ahead window at epoch resolution so no
        # phase bin inside [t, t + lead] can be skipped over
        step = max(min(self.scfg.interval, self.lead), 1e-9)
        leads = [k * step for k in range(int(self.lead / step) + 1)]
        if leads[-1] < self.lead:
            leads.append(self.lead)
        return leads

    def target(self, t: float, rate: float, needed: int,
               queued: int) -> int:
        sc, fc = self.autoscaler, self.forecaster
        sc.observe(rate, needed)
        fc.observe(t, rate)
        b_now = self._bin(t)
        self._season_needed[b_now] = max(self._season_needed.get(b_now, 0),
                                         needed)
        leads = self._leads()
        r_ahead = max(fc.forecast(t, dl) for dl in leads)
        tgt = sc.predict_workers(max(rate, r_ahead), last_needed=needed)
        floor = max(self._season_needed.get(self._bin(t + dl), 0)
                    for dl in leads)
        return max(tgt, floor)

    def split(self, t: float, target: int) -> Tuple[int, int]:
        """Carve ``target`` into (n_on_demand, n_spot) for this epoch.

        The always-on base — the smallest worker count any observed phase
        has needed (the diurnal trough) — is pinned to on-demand capacity;
        only the swing above it is eligible for spot. Within that bound the
        economics of ``split_spot_mix`` decide, so a hazard spike or a thin
        discount degrades gracefully to all-on-demand."""
        mix = self.spot_mix
        if mix is None:
            return target, 0
        n_od, n_spot = split_spot_mix(target, mix)
        if mix.spot_frac is None and self._season_needed:
            trough = min(self._season_needed.values())
            base = min(trough, target)
            if base > n_od and n_spot > 0:
                n_od = base
                n_spot = int(math.ceil(max(target - base, 0)
                                       / max(mix.survival(), 1e-9)))
        return n_od, n_spot


class FeedbackPolicy:
    """Closed-loop SLO-feedback scaling: an open-loop policy (reactive or
    forecast) proposes each epoch's worker target, and an
    :class:`~repro.core.scaling.AttainmentController` corrects it from the
    *observed* windowed SLO attainment the cluster delivered.

    The wrapper composes rather than replaces: the inner policy keeps its
    whole demand model (Eq. 7 fit, forecaster, seasonal floor, spot split),
    so the feedback term only has to absorb what the demand model got wrong
    — a drifted seasonality boosts the gain at the mispredicted ramps and
    releases it in the over-provisioned troughs. ``metric`` selects which
    SLO dimension the controller watches (``both`` for a colocated tier,
    ``ttft`` for a prefill side, ``atgt`` for a decode side); the pool feeds
    ``observe_slo`` once per scaling epoch from the topology's windowed
    attainment. With an infinite deadband the controller never moves off
    gain 1.0 and the closed loop reproduces the open-loop policy
    bit-for-bit (pinned by tests/test_feedback.py)."""

    name = "feedback"

    def __init__(self, inner, fcfg: Optional[FeedbackConfig] = None,
                 metric: str = "both"):
        self.inner = inner
        self.fcfg = fcfg or FeedbackConfig()
        self.metric = metric
        self.controller = AttainmentController(self.fcfg)

    @property
    def scfg(self) -> ScaleSimConfig:
        return self.inner.scfg

    @property
    def spot_mix(self):
        return getattr(self.inner, "spot_mix", None)

    @property
    def gain(self) -> float:
        return self.controller.gain

    @property
    def window(self) -> float:
        return self.fcfg.window

    def observe_slo(self, t: float, ok: int, total: int) -> None:
        self.controller.observe(t, ok, total)

    def target(self, t: float, rate: float, needed: int,
               queued: int) -> int:
        return self.controller.apply(
            self.inner.target(t, rate, needed, queued))

    def split(self, t: float, target: int) -> Tuple[int, int]:
        return self.inner.split(t, target)


# ---- autoscaled simulation ---------------------------------------------------

@dataclasses.dataclass
class SpotMarket:
    """A preemptible capacity pool the engine may buy from: the spot worker
    type (same hardware as the on-demand spec, discounted ``price``, non-zero
    ``preempt_hazard``) plus the market's reclaim-event trace
    (``workload.preemption_trace``). Each event kills a slice of the spot
    workers alive at that instant — on-demand workers are never touched.

    ``notice_s`` models the preemption notice real clouds give (30-120 s):
    a reclaimed worker drains — no new admissions, in-flight decode may
    finish until the deadline — instead of dying instantly; whatever is
    still running at the deadline is killed and requeued with the usual
    KV-loss recovery cost. ``RunReport`` records ``drained_ok`` vs
    ``killed``. ``notice_s=0`` (default) is the instant-kill behavior.

    On a disaggregated topology ``spec``/``events`` drive the *decode* side
    (a decode reclaim loses KV and pays a full re-prefill plus KV
    re-transfer); ``prefill_spec``/``prefill_events`` describe the
    prefill-side market, whose reclaims are nearly free (queued prompts just
    re-queue) — which is why asymmetric hazards/discounts between the two
    sides are worth modeling at all."""
    spec: WorkerSpec
    events: Sequence[PreemptionEvent] = dataclasses.field(
        default_factory=list)
    notice_s: float = 0.0
    prefill_spec: Optional[WorkerSpec] = None
    prefill_events: Sequence[PreemptionEvent] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class EpochStat:
    t: float                 # epoch start time
    rate: float              # observed arrivals / interval
    needed: int              # peak busy workers (+1 if a backlog remained)
    target: int              # policy decision for the next epoch (total)
    online: int              # workers online after applying the decision
    target_spot: int = 0     # spot share of the target
    online_spot: int = 0     # spot workers online after the decision


@dataclasses.dataclass
class ScaleSimResult:
    policy: str
    gpu_seconds: float       # Σ billed cost (gpu_cost * dt over the fleet,
    attainment: float        # in on-demand accelerator-second equivalents)
    p99_ttft: float
    p99_atgt: float
    mean_atgt: float
    finished: int
    total: int
    peak_workers: int
    spot_gpu_seconds: float = 0.0    # billed share from the spot pool
    preempted_workers: int = 0       # spot workers reclaimed mid-flight
    requeued: int = 0                # requests that lost KV and re-entered
    epochs: List[EpochStat] = dataclasses.field(default_factory=list)

    def row(self) -> Dict:
        d = dataclasses.asdict(self)
        d.pop("epochs")
        return d


class ManagedPool:
    """Policy-driven worker lifecycle extracted from the pre-Scenario
    ``simulate_autoscaled``: boot delay (billed while booting), voluntary
    draining on scale-down, retirement, price-class-aware booting, per-price
    billing, market reclaims and the preemption-notice drain window.

    Generic over the worker kind via adapter callables — ``new_worker(spec)``
    builds one, ``on_spawn(w, t)`` arms its execution model, ``on_kill(w)``
    strips and returns its in-flight requests, ``load(w)``/``idle(w)`` rank
    drain victims and detect retirement, ``mark(r, t)`` stamps the recovery
    cost class on reclaimed work — so the colocated tier and either side of
    a disaggregated cluster scale through one state machine."""

    def __init__(self, spec: WorkerSpec, scfg: ScaleSimConfig, policy,
                 heartbeat: float, rng, *, new_worker, on_spawn, on_kill,
                 load, idle, mark=mark_kv_loss, sims=None,
                 spot_spec: Optional[WorkerSpec] = None,
                 notice_s: float = 0.0, name: str = "serve"):
        self.spec = spec
        self.scfg = scfg
        self.policy = policy
        self.rng = rng
        self.spot_spec = spot_spec
        self.name = name
        self._new_worker = new_worker
        self._on_spawn = on_spawn
        self._load = load
        self._idle = idle
        self.sims = sims if sims is not None else {}
        self.factory = None                # managed pools never place-to-open
        self.beats_per_epoch = max(int(round(scfg.interval / heartbeat)), 1)
        self.online: List = []
        self.draining: List = []
        self.booting: List[List] = []      # [online_at, worker]
        self.life = WorkerLifecycle(
            rng, notice_s=notice_s, extract=on_kill, mark=mark, idle=idle,
            remove=self._remove, on_condemn=self._condemn)
        self.epochs: List[EpochStat] = []
        self.acc = {"gpu_s": 0.0, "spot_gpu_s": 0.0, "beat": 0,
                    "arrivals": 0, "busy_peak": 0, "peak": 0}
        for _ in range(max(scfg.initial_workers, scfg.min_workers)):
            w = self._new_worker(self.spec)
            self.online.append(w)
            self._on_spawn(w, 0.0)

    # ---- WorkerLifecycle adapters -------------------------------------------
    def _remove(self, w) -> None:
        (self.online if w in self.online else self.draining).remove(w)
        # flush the worker's execution-model state: a voluntarily drained
        # retirement never goes through on_kill (nothing to extract), so
        # without this pop the sims entry — and any prefix cache it holds —
        # would outlive the worker and leak stale session prefixes into
        # ``drained()`` checks and the cache ledger
        sim = self.sims.pop(w.id, None)
        if sim is not None and getattr(sim, "cache", None) is not None:
            sim.cache.vaporize()

    def _condemn(self, w) -> None:
        # the provider is taking it back: drain immediately (no admissions)
        if w in self.online:
            self.online.remove(w)
            self.draining.append(w)

    # ---- accessors the topologies use ---------------------------------------
    @property
    def gpu_s(self) -> float:
        return self.acc["gpu_s"]

    @property
    def spot_gpu_s(self) -> float:
        return self.acc["spot_gpu_s"]

    @property
    def killed(self) -> int:
        return self.life.killed

    @property
    def drained_ok(self) -> int:
        return self.life.drained_ok

    @property
    def requeued(self) -> int:
        return self.life.requeued

    @property
    def peak(self) -> int:
        return self.acc["peak"]

    def note_arrival(self) -> None:
        self.acc["arrivals"] += 1

    def serving(self) -> List:
        return self.online

    def active(self) -> List:
        return self.online + self.draining

    # ---- per-beat lifecycle --------------------------------------------------
    def begin_beat(self, topo, t: float) -> None:
        # workers whose boot completed join the serving set
        ready = [b for b in self.booting if b[0] <= t]
        for b in ready:
            self.booting.remove(b)
            w = b[1]
            self.online.append(w)
            self._on_spawn(w, t)
        if self.life.condemned:
            topo.requeue(self.reap_condemned(t), side=self.name)

    def end_beat(self, topo, t: float, t_next: float) -> None:
        # retire drained workers (billing stops with this heartbeat); a
        # condemned worker that got here finished inside its notice window
        for w in list(self.draining):
            self.life.retire_if_idle(w)
        busy = sum(1 for w in self.online if self._load(w) > 0)
        self.acc["busy_peak"] = max(self.acc["busy_peak"], busy)
        self.acc["peak"] = max(self.acc["peak"], len(self.online))
        dt = t_next - t
        billed = [w.spec for w in self.online] \
            + [w.spec for w in self.draining] \
            + [b[1].spec for b in self.booting]
        self.acc["gpu_s"] += sum(s.gpu_cost for s in billed) * dt
        self.acc["spot_gpu_s"] += sum(s.gpu_cost for s in billed
                                      if s.is_spot) * dt
        self.acc["beat"] += 1
        if self.acc["beat"] % self.beats_per_epoch == 0:
            n_queued = topo.backlog_len(self.name)
            self._scale_epoch(topo, t_next, busy, n_queued)

    def absorb_chunk(self, topo, t_next: float, dts: Sequence[float],
                     retiring: dict, busy_final: int, busy_peak: int,
                     arrivals: int, n_queued: int) -> None:
        """Replay ``len(dts)`` beats of ``end_beat`` bookkeeping at once —
        the settlement half of the compiled (jax) engine's chunked
        execution. The kernel advanced the lanes; this replays the exact
        per-beat billing order (retire drained workers *before* billing the
        beat, each beat's ``dt`` accumulated left-to-right) so
        ``gpu_seconds`` matches stepwise execution bit-for-bit.

        ``retiring`` maps chunk-local beat index -> draining workers that
        first emptied on that beat (in draining-list order); ``busy_peak``
        / ``busy_final`` are the kernel's loaded-online-lane stats;
        ``arrivals`` counts kernel-admitted requests. Chunks are cut at
        epoch boundaries, so at most the final beat fires ``_scale_epoch``
        — with exactly the state stepwise execution would have seen."""
        self.acc["arrivals"] += arrivals
        for j, dt in enumerate(dts):
            for w in retiring.get(j, ()):
                self.life.retire_if_idle(w)
            billed = [w.spec for w in self.online] \
                + [w.spec for w in self.draining] \
                + [b[1].spec for b in self.booting]
            self.acc["gpu_s"] += sum(s.gpu_cost for s in billed) * dt
            self.acc["spot_gpu_s"] += sum(s.gpu_cost for s in billed
                                          if s.is_spot) * dt
        self.acc["busy_peak"] = max(self.acc["busy_peak"], busy_peak)
        self.acc["peak"] = max(self.acc["peak"], len(self.online))
        self.acc["beat"] += len(dts)
        if self.acc["beat"] % self.beats_per_epoch == 0:
            self._scale_epoch(topo, t_next, busy_final, n_queued)

    def _scale_epoch(self, topo, t_next: float, busy: int,
                     n_queued: int) -> None:
        scfg = self.scfg
        rate = self.acc["arrivals"] / scfg.interval
        # feedback policies close the loop on what the cluster actually
        # delivered: feed them the topology's windowed observed attainment
        # (a pure read — open-loop policies skip this entirely)
        observe = getattr(self.policy, "observe_slo", None)
        if observe is not None:
            ok, total = topo.slo_window(
                self.name, t_next, getattr(self.policy, "window",
                                           scfg.interval),
                getattr(self.policy, "metric", "both"))
            observe(t_next, ok, total)
        # workers needed = peak busy set, plus enough extra workers to
        # absorb any placement backlog at the typical per-worker batch
        if n_queued:
            per_w = sum(self._load(w) for w in self.online) / max(busy, 1)
            backlog = max(int(math.ceil(n_queued / max(per_w, 1.0))), 1)
        else:
            backlog = 0
        needed = self.acc["busy_peak"] + backlog
        t_epoch = t_next - scfg.interval
        tgt = self.policy.target(t_epoch, rate, needed, n_queued)
        if scfg.headroom != 1.0:
            tgt = int(math.ceil(tgt * scfg.headroom))
        tgt = max(tgt, busy, scfg.min_workers)
        tgt = min(tgt, scfg.max_workers)
        # price-class split: policies without one (or no spot market to buy
        # from) run all-on-demand
        split = getattr(self.policy, "split", None)
        if self.spot_spec is not None and split is not None:
            tgt_od, tgt_spot = split(t_epoch, tgt)
            tgt_spot = min(tgt_spot, scfg.max_workers - tgt_od)
        else:
            tgt_od, tgt_spot = tgt, 0
        self.apply_target(t_next, tgt_od, tgt_spot, bool(n_queued))
        self.epochs.append(EpochStat(
            t=t_epoch, rate=rate, needed=needed, target=tgt_od + tgt_spot,
            online=len(self.online), target_spot=tgt_spot,
            online_spot=sum(1 for w in self.online if w.spec.is_spot)))
        self.acc["arrivals"] = 0
        self.acc["busy_peak"] = 0

    def apply_target(self, t: float, tgt_od: int, tgt_spot: int,
                     has_backlog: bool) -> None:
        target = tgt_od + tgt_spot
        cur = len(self.online) + len(self.booting)
        if target > cur:
            want = target - cur
            # reclaim draining workers first: they are warm, boot is free —
            # but never one inside a preemption notice (the provider is
            # taking it back regardless)
            while want > 0 and self.draining:
                cand = [w for w in self.draining
                        if w.id not in self.life.condemned]
                if not cand:
                    break
                w = cand[-1]
                self.draining.remove(w)
                self.online.append(w)
                want -= 1
            # boot composition: fill the spot deficit first (it is the
            # cheaper capacity), the remainder on-demand
            n_spot_cur = sum(1 for w in self.online if w.spec.is_spot) \
                + sum(1 for b in self.booting if b[1].spec.is_spot)
            want_spot = min(max(tgt_spot - n_spot_cur, 0), max(want, 0))
            for i in range(want):
                wspec = self.spot_spec \
                    if self.spot_spec is not None and i < want_spot \
                    else self.spec
                self.booting.append([t + self.scfg.provision_delay,
                                     self._new_worker(wspec)])
        elif target < cur:
            excess = cur - target
            # cancel pending boots first (nothing running on them yet)
            while excess > 0 and self.booting:
                self.booting.pop()
                excess -= 1
            # then drain the emptiest online workers; never below the busy
            # set — draining a loaded worker strands its queue time
            victims = sorted(self.online, key=self._load)
            for w in victims:
                if excess <= 0 or len(self.online) <= self.scfg.min_workers:
                    break
                if self._load(w) > 0 and has_backlog:
                    break             # backlog: keep every loaded worker
                self.online.remove(w)
                self.draining.append(w)
                excess -= 1

    # ---- market reclaims -----------------------------------------------------
    def on_reclaim(self, t: float, ev: PreemptionEvent) -> List[Request]:
        """A market reclaim: take ceil(frac * spot pool) spot workers —
        online, draining or still booting. The shared
        :class:`WorkerLifecycle` machine decides instant-kill vs condemn;
        a cancelled boot never held requests (it was billed, which
        gpu_seconds already reflects). Returns the requests knocked back
        into the queue."""
        pool = self.life.eligible(self.online) \
            + self.life.eligible(self.draining)
        boots = [b for b in self.booting if b[1].spec.is_spot]
        return self.life.reclaim(t, ev, pool, boots=boots,
                                 cancel_boot=self.booting.remove)

    def reap_condemned(self, t: float) -> List[Request]:
        """Kill condemned workers whose notice deadline has passed; workers
        that drained empty first are retired (and counted ``drained_ok``)
        by the regular end-of-beat retirement."""
        return self.life.reap(
            t, lambda wid: next((x for x in self.draining if x.id == wid),
                                None),
            retire_idle=False)


def simulate_autoscaled(trace: Sequence[Request], spec: WorkerSpec, slo: SLO,
                        cfg: SimConfig, scfg: ScaleSimConfig, policy,
                        predictor=None,
                        spot: Optional[SpotMarket] = None) -> ScaleSimResult:
    """Colocated serving with a policy-driven worker lifecycle.

    Same causal-time heartbeat core and placement as ``simulate``, but the
    worker count is owned by ``policy.target(t, rate, needed, queued)``
    evaluated once per scaling epoch: new workers take ``provision_delay``
    seconds to boot (billed while booting), surplus workers drain (no new
    placements; billed until their last request finishes) and a scale-up
    reclaims draining workers before booting cold ones.  ``gpu_seconds`` is
    the billed accelerator time, each worker at its own price class — the
    cost metric the reactive-vs-forecast(-vs-spot) benchmarks compare.

    With a ``SpotMarket``, the policy's ``split(t, target)`` (all-on-demand
    for policies without one) decides each epoch's price-class mix; booted
    workers fill the spot deficit first (it is the cheaper capacity). When a
    market reclaim event lands — delivered by the heartbeat core under the
    same causal rule as arrivals — a slice of the live spot workers dies:
    every in-flight request on them loses its KV, re-enters the queue (its
    generated-token count is retained), and pays a full context re-prefill
    plus the stall, charged against its TTFT/ATGT clocks by the simulator
    core. Scale-down stays price-class-blind (drain the emptiest worker
    wherever it is); the boot composition re-converges the realized mix to
    the split at the next epoch, so a zero-hazard, undiscounted spot pool
    reproduces the on-demand simulation exactly."""
    from repro_torch.serving import api

    scenario = api.Scenario(
        workload=trace,
        fleet=api.FleetSpec([api.PoolSpec(spec, scfg.initial_workers)]),
        slo=slo,
        topology=api.Colocated(heartbeat=cfg.heartbeat, policy=cfg.policy,
                               split_phase=cfg.split_phase,
                               rebalance=cfg.rebalance, gamma=cfg.gamma,
                               theta=cfg.theta, max_batch=cfg.max_batch),
        scaling=api.PolicyScale(policy=policy, scfg=scfg),
        market=spot, predictor=predictor, seed=cfg.seed)
    return api.run(scenario).to_scale_result()
