"""One declarative Scenario API over every cluster simulator.

The repo's simulators grew as three disjoint entry points — ``simulate``
(colocated), ``simulate_disaggregated`` and ``simulate_autoscaled`` — which
made the paper's most interesting regime (autoscaled, SLO-aware
*disaggregated* pools under spot pricing) inexpressible. This module gives
the codebase exactly two verbs over one declarative description:

    report = run(Scenario(workload=..., fleet=FleetSpec(...), slo=...,
                          topology=Colocated() | Disaggregated(),
                          scaling=FixedScale(n) | Reactive() | Forecast(),
                          market=SpotMarket(...) | None))
    plan   = optimize(scenario, objective="cost")

Internally every combination runs one engine path: the existing causal
heartbeat loop (``simulator.run_heartbeat_loop``) drives a *topology*
(``ColocatedTopology`` or ``DisaggTopology``) whose worker containers are
either static (``FixedPool`` / fixed sides) or policy-scaled
(``forecast.ManagedPool``), with the spot market's reclaim events delivered
causally to whichever container owns the victims. That is what makes the
2 topologies x 3 scaling modes x {on-demand, spot} matrix composable —
including the cell none of the legacy entry points could express:
autoscaled disaggregated pools with asymmetric spot hazards, where a
decode-pool reclaim pays a full context re-prefill plus KV re-transfer
while a prefill-pool reclaim merely re-queues prompts.

The legacy entry points remain as thin deprecation shims that build the
equivalent ``Scenario`` and reproduce their pre-refactor metrics
bit-for-bit (tests/test_shim_goldens.py pins them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.scaling import FeedbackConfig, SpotMixConfig
from repro_torch.core.slo import SLO, slo_attainment
from repro_torch.core.worker_config import WorkerSpec
from repro_torch.serving.disagg import (DisaggConfig, DisaggResult, DisaggTopology,
                                  FixedDecodeSide, FixedPrefillSide,
                                  ManagedSide, PrefillSimWorker, pool_cost,
                                  ratio_pool_fn)
from repro_torch.serving.forecast import (EpochStat, FeedbackPolicy, ForecastConfig,
                                    ForecastPolicy, ManagedPool,
                                    ReactivePolicy, ScaleSimConfig,
                                    ScaleSimResult, SeasonalNaiveForecaster,
                                    SpotMarket)
from repro_torch.serving.lifecycle import mark_requeue
from repro_torch.serving.length_predictor import LengthPredictor
from repro_torch.serving.simulator import (ColocatedTopology, FixedPool, SimConfig,
                                     SimResult, SimWorker,
                                     make_worker_state, run_heartbeat_loop)
from repro_torch.serving.tenants import (TenantSpec, materialize_tenants,
                                   planning_slo, tenant_attainment,
                                   tenant_rows)
from repro_torch.serving.workload import clone_trace

# ---- scenario vocabulary -----------------------------------------------------


@dataclasses.dataclass
class PoolSpec:
    """One worker type in the fleet: its spec, how many to start with, and
    which tier it serves (``serve`` for colocated, ``prefill``/``decode``
    for a disaggregated topology). Under ``FixedScale`` the count IS the
    pool size; under ``Reactive``/``Forecast`` it seeds ``initial_workers``
    and the policy owns the count from there.

    ``tenants`` expresses LoRA/multi-tenant *placement as a decision*: None
    (the default) is a shared pool every tenant may place on; a list of
    tenant names makes the pool dedicated — only those tenants' requests
    are eligible for its workers. ``optimize()`` on a multi-tenant scenario
    searches shared-vs-dedicated pool assignments through this field."""
    spec: WorkerSpec
    count: int = 0
    role: str = "serve"
    tenants: Optional[Sequence[str]] = None


@dataclasses.dataclass
class FleetSpec:
    """The worker types a scenario may buy, grouped by role."""
    pools: Sequence[PoolSpec] = dataclasses.field(default_factory=list)

    def for_role(self, role: str) -> List[PoolSpec]:
        sel = [p for p in self.pools if p.role == role]
        if not sel and role == "serve":
            # a role-less fleet serves the colocated tier
            sel = [p for p in self.pools if p.role not in ("prefill",
                                                           "decode")]
        return sel


@dataclasses.dataclass
class Colocated:
    """Single-tier topology: prefill and decode share every worker
    (the classic ``simulate`` world, including split_phase decode-only
    fleets for Fig. 12).

    Multi-turn sessions (``workload.session_trace``) add two decisions:
    ``router`` — ``"sticky"`` prefers each session's previous worker while
    it passes every placement constraint (falling through to ``policy``
    otherwise), ``"blind"`` ignores affinity — and ``prefix_cache`` —
    ``"lru"`` lets workers keep finished session contexts in spare KV so a
    returning turn prefills only its new tokens, ``"off"`` disables reuse.
    ``cache_tokens`` caps the per-worker cache footprint (None = spare-KV
    pressure only). Single-shot traces are untouched by all three knobs;
    the compiled cores reject session scenarios (reference engine only)."""
    heartbeat: float = 0.25
    policy: str = "aladdin"            # aladdin | jsq | po2
    split_phase: bool = False
    rebalance: bool = True
    gamma: float = 0.5
    theta: float = 0.9
    max_batch: int = 128
    router: str = "blind"              # blind | sticky (session affinity)
    prefix_cache: str = "lru"          # lru | off (session KV reuse)
    cache_tokens: Optional[int] = None  # per-worker cache cap, tokens


@dataclasses.dataclass
class Disaggregated:
    """Two-tier topology: prefill pools hand KV to decode pools over a
    modeled interconnect (the ``simulate_disaggregated`` world)."""
    heartbeat: float = 0.05
    policy: str = "aladdin"            # decode placement: aladdin | jsq
    gamma: float = 0.5
    theta: float = 0.9
    kv_transfer_bw: float = 64e9
    kv_transfer_lat: float = 2e-3
    prefill_router: str = "packed"     # packed (legacy) | earliest
    decode_router: str = "packed"      # packed (legacy) | earliest


@dataclasses.dataclass
class FixedScale:
    """No autoscaling. ``n`` workers of the first pool type, or the fleet's
    explicit per-pool counts when ``n`` is None; a colocated fleet with
    neither runs *elastic* (open a worker whenever placement fails — the
    min-cost oracle)."""
    n: Optional[int] = None


@dataclasses.dataclass
class SideOverride:
    """Per-side parameter overrides for an autoscaled *disaggregated*
    scenario (``None`` inherits the scaling mode's value). The two sides
    genuinely want different settings: TTFT burns in the arrival->prefill
    hop, so the prefill side reacts on a short ``lead``; ATGT pressure
    builds through the handoff->decode pipeline, so the decode side wants a
    longer one (and its own headroom). ``window``/``metric`` tune the
    side's SLO-feedback controller (``FeedbackScale``)."""
    lead: Optional[float] = None
    headroom: Optional[float] = None
    interval: Optional[float] = None
    min_workers: Optional[int] = None
    window: Optional[float] = None            # feedback attainment window
    metric: Optional[str] = None              # feedback: ttft | atgt | both


@dataclasses.dataclass
class Reactive:
    """Eq. 7 scaling on the last observed rate, with a scale-down cooldown
    (``forecast.ReactivePolicy``)."""
    interval: float = 5.0
    provision_delay: float = 10.0
    cooldown: float = 60.0
    min_workers: int = 1
    max_workers: int = 512
    initial_workers: Optional[int] = None     # None: the fleet pool counts
    headroom: float = 1.0                     # SLO head-room on targets
    spot_mix: Optional[SpotMixConfig] = None
    prefill: Optional[SideOverride] = None    # disaggregated per-side knobs
    decode: Optional[SideOverride] = None


@dataclasses.dataclass
class Forecast:
    """Eq. 7 scaling on a seasonal-naive + EWMA-residual forecast
    ``provision_delay + interval`` ahead (``forecast.ForecastPolicy``).
    ``spot_mix`` overrides the economics derived from the market's spot
    spec (discount = spot price, hazard = its reclaim rate)."""
    interval: float = 5.0
    provision_delay: float = 10.0
    lead: Optional[float] = None
    period: float = 300.0
    bin_width: Optional[float] = None         # None: one bin per interval
    min_workers: int = 1
    max_workers: int = 512
    initial_workers: Optional[int] = None
    headroom: float = 1.0                     # SLO head-room on targets
    spot_mix: Optional[SpotMixConfig] = None
    prefill: Optional[SideOverride] = None    # disaggregated per-side knobs
    decode: Optional[SideOverride] = None


@dataclasses.dataclass
class FeedbackScale:
    """Closed-loop SLO-feedback scaling: ``base`` (an open-loop ``Forecast``
    or ``Reactive`` declaration) proposes each epoch's target and an
    attainment controller corrects it from the windowed SLO attainment the
    cluster actually delivered — a multiplicative gain boost while
    attainment sits below ``slo_target - deadband``, an additive release
    (down to ``min_gain``, below 1.0 shaving open-loop over-provisioning)
    while it saturates above ``slo_target + deadband``, hysteresis in
    between. On a disaggregated topology each side runs its own controller:
    prefill reacts on TTFT attainment, decode on ATGT attainment
    (``metric="auto"``), with the base's ``prefill``/``decode``
    ``SideOverride`` supplying per-side leads/windows. An infinite
    ``deadband`` reproduces the open-loop base bit-for-bit."""
    base: Union[Forecast, Reactive] = dataclasses.field(
        default_factory=Forecast)
    slo_target: float = 0.99
    deadband: float = 0.005
    boost: float = 1.3
    decay: float = 0.02
    max_gain: float = 3.0
    min_gain: float = 1.0
    window: float = 30.0
    min_samples: int = 8
    attack_cooldown: Optional[float] = None   # None: one boost per window
    metric: str = "auto"       # auto: both | ttft (prefill) | atgt (decode)


@dataclasses.dataclass
class PolicyScale:
    """Escape hatch wrapping a prebuilt policy instance + ScaleSimConfig —
    the legacy ``simulate_autoscaled`` calling convention. Colocated only
    (a disaggregated scenario needs one independent policy per side, which
    only the declarative forms can build)."""
    policy: object
    scfg: ScaleSimConfig


ScalingLike = Union[FixedScale, Reactive, Forecast, FeedbackScale,
                    PolicyScale]
TopologyLike = Union[Colocated, Disaggregated]


@dataclasses.dataclass
class Scenario:
    """A complete, declarative description of one serving experiment:
    what arrives (``workload``: a concrete trace or a zero-arg trace
    factory), what it runs on (``fleet``), how the tiers are arranged
    (``topology``), who owns the worker counts (``scaling``), whether a
    preemptible market exists (``market``), and the SLO it is judged by.

    Multi-tenant scenarios pass ``tenants=[TenantSpec(...), ...]`` in
    place of the scalar ``workload``/``slo`` pair: the merged trace tags
    every request with its tenant, the queue becomes priority-then-EDF,
    attainment is judged per tenant against its own SLO, and ``slo``
    defaults to the *planning* SLO (the strictest across tenants; an
    explicit ``slo`` overrides that planning value only). ``workload``
    may still be set alongside ``tenants`` when it is an already-merged,
    already-tagged trace (``optimize`` replays candidates this way)."""
    workload: object = None            # Sequence[Request] | () -> Sequence
    fleet: Optional[FleetSpec] = None
    slo: Optional[SLO] = None
    topology: TopologyLike = dataclasses.field(default_factory=Colocated)
    scaling: ScalingLike = dataclasses.field(default_factory=FixedScale)
    market: Optional[SpotMarket] = None
    predictor: Optional[LengthPredictor] = None
    observer: Optional[Callable] = None
    seed: int = 0
    # which simulation core executes the scenario:
    #   reference  — the per-object Python engine (every feature; the oracle)
    #   vectorized — the numpy struct-of-arrays core (serving.fastsim):
    #                bit-for-bit the reference on fixed colocated fleets,
    #                ValueError outside that envelope
    #   jax        — the jit/scan compiled core (serving.fastsim_jax):
    #                fixed colocated aladdin/jsq fleets with inert KV;
    #                optimize() evaluates candidate batches in one call
    engine: str = "reference"
    # multi-tenant form: a list of TenantSpec in place of workload/slo
    tenants: Optional[Sequence[TenantSpec]] = None

    def materialize(self) -> List:
        """The workload as a concrete request list (evaluating a trace
        factory once); use ``workload.clone_trace`` to replay it. A
        multi-tenant scenario without an explicit merged ``workload``
        materializes every tenant stream and merges them
        (:func:`repro.serving.tenants.materialize_tenants`)."""
        if self.workload is None:
            if self.tenants is None:
                raise ValueError("Scenario needs a workload (or tenants)")
            return materialize_tenants(self.tenants)
        w = self.workload
        return list(w() if callable(w) else w)


def resolve_scenario(sc: Scenario) -> Scenario:
    """The scalar view of a scenario: validate the workload/slo vs tenants
    contract and, for a multi-tenant scenario without an explicit ``slo``,
    fill in the planning SLO (strictest TTFT/ATGT across tenants) that
    parameterizes worker-level placement scoring. Idempotent; every engine
    entry point calls this first so direct engine calls see the same
    contract as ``run()``."""
    if sc.fleet is None:
        raise ValueError("Scenario needs a fleet")
    if sc.tenants is not None:
        if not isinstance(sc.topology, Colocated):
            raise ValueError("Scenario.tenants is a Colocated-topology "
                             "feature; a disaggregated multi-tenant fleet "
                             "is not modeled")
        if not sc.tenants:
            raise ValueError("Scenario.tenants must be non-empty when set")
        if sc.slo is None:
            sc = dataclasses.replace(sc, slo=planning_slo(sc.tenants))
    if sc.slo is None:
        raise ValueError("Scenario needs an slo (or tenants)")
    if sc.workload is None and sc.tenants is None:
        raise ValueError("Scenario needs a workload (or tenants)")
    return sc


# ---- the unified run record --------------------------------------------------


@dataclasses.dataclass
class RunReport:
    """The one versioned result record every ``run()`` returns — the union
    of the three legacy ``*Result.row()`` schemas. ``row()`` is the flat
    dict the benchmarks write; the ``to_*_result`` adapters feed the
    deprecation shims bit-for-bit."""
    schema: str = "runreport/2"
    topology: str = "colocated"        # colocated | disaggregated
    scaling: str = "fixed"             # fixed | elastic | policy name
    attainment: float = 0.0
    p99_ttft: float = float("nan")
    p99_atgt: float = float("nan")
    mean_atgt: float = float("nan")
    finished: int = 0
    total: int = 0
    peak_workers: int = 0
    gpu_cost: float = 0.0              # fleet cost (fixed) / billed (scaled)
    gpu_seconds: float = 0.0           # billed accelerator-seconds (scaled)
    spot_gpu_seconds: float = 0.0
    moves: int = 0
    n_prefill: int = 0
    n_decode: int = 0
    pool_mix: str = ""
    mean_transfer: float = 0.0
    kv_retransfers: int = 0
    preempted_workers: int = 0         # instant/deadline kills with loss
    drained_ok: int = 0                # reclaims that drained in the notice
    requeued: int = 0
    lora_swaps: int = 0                # adapter fault-ins (LoRA tenants)
    # multi-turn sessions: prefix-cache effectiveness. hit_rate is over
    # cacheable lookups (turns with a prior context; turn-0 requests have
    # nothing to reuse and are not counted); evictions count entries
    # dropped to capacity pressure, drain retirement or spot vaporization.
    cache_hit_rate: float = 0.0
    prefix_evictions: int = 0
    epochs: Dict[str, List[EpochStat]] = dataclasses.field(
        default_factory=dict)
    # per-tenant breakdown (multi-tenant scenarios): attainment vs the
    # tenant's own SLO, p99 TTFT/ATGT, queue delay, gpu-cost share. Like
    # ``epochs`` it is excluded from ``row()`` — benchmarks that want the
    # breakdown write it explicitly.
    tenant_rows: List[Dict] = dataclasses.field(default_factory=list)

    def row(self) -> Dict:
        d = dataclasses.asdict(self)
        d.pop("epochs")
        d.pop("tenant_rows")
        return d

    # ---- legacy adapters (deprecation shims) --------------------------------
    def to_sim_result(self) -> SimResult:
        return SimResult(n_workers_peak=self.peak_workers,
                         attainment=self.attainment, p99_atgt=self.p99_atgt,
                         p99_ttft=self.p99_ttft, mean_atgt=self.mean_atgt,
                         finished=self.finished, total=self.total,
                         moves=self.moves, gpu_cost=self.gpu_cost)

    def to_disagg_result(self) -> DisaggResult:
        return DisaggResult(n_prefill=self.n_prefill,
                            n_decode=self.n_decode, gpu_cost=self.gpu_cost,
                            attainment=self.attainment,
                            p99_ttft=self.p99_ttft, p99_atgt=self.p99_atgt,
                            mean_transfer=self.mean_transfer,
                            finished=self.finished, total=self.total,
                            pool_mix=self.pool_mix)

    def to_scale_result(self) -> ScaleSimResult:
        return ScaleSimResult(policy=self.scaling,
                              gpu_seconds=self.gpu_seconds,
                              attainment=self.attainment,
                              p99_ttft=self.p99_ttft,
                              p99_atgt=self.p99_atgt,
                              mean_atgt=self.mean_atgt,
                              finished=self.finished, total=self.total,
                              peak_workers=self.peak_workers,
                              spot_gpu_seconds=self.spot_gpu_seconds,
                              preempted_workers=self.preempted_workers,
                              requeued=self.requeued,
                              epochs=self.epochs.get("serve", []))


@dataclasses.dataclass
class Plan:
    """What ``optimize`` found: the winning concrete scenario (None when
    nothing within the search bounds attains the target), its report, and
    the search account. For a policy-space search over an autoscaled
    scenario, ``params`` records the winning axis assignment (axes left at
    the scenario's declared value are absent)."""
    objective: str
    scenario: Optional[Scenario]
    report: Optional[RunReport]
    n_workers: int = 0
    cost: float = float("nan")
    evals: int = 0
    params: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def feasible(self) -> bool:
        return self.report is not None

    @property
    def disagg_result(self) -> Optional[DisaggResult]:
        return self.report.to_disagg_result() if self.report else None


# ---- metric assembly ---------------------------------------------------------


def _percentiles(finished, total, slo) -> Dict:
    atgts = [r.atgt() for r in finished if r.atgt() is not None]
    ttfts = [r.ttft() for r in finished if r.ttft() is not None]
    return dict(
        attainment=slo_attainment(finished, total, slo),
        p99_atgt=float(np.percentile(atgts, 99)) if atgts else float("nan"),
        p99_ttft=float(np.percentile(ttfts, 99)) if ttfts else float("nan"),
        mean_atgt=float(np.mean(atgts)) if atgts else float("nan"),
        finished=len(finished), total=total)


# ---- scaling builders --------------------------------------------------------


def _open_loop(s: ScalingLike):
    """The open-loop declaration under a scaling mode: ``FeedbackScale``
    corrects its ``base``, everything else is its own open loop."""
    return s.base if isinstance(s, FeedbackScale) else s


def _side_override(s: ScalingLike, side: Optional[str]) -> SideOverride:
    ov = getattr(_open_loop(s), side, None) if side in ("prefill",
                                                        "decode") else None
    return ov if ov is not None else SideOverride()


def _scale_cfg(s: ScalingLike, initial: int,
               side: Optional[str] = None) -> ScaleSimConfig:
    base = _open_loop(s)
    ov = _side_override(s, side)
    return ScaleSimConfig(
        interval=ov.interval if ov.interval is not None else base.interval,
        provision_delay=base.provision_delay,
        cooldown=getattr(base, "cooldown", 60.0),
        lead=ov.lead if ov.lead is not None else getattr(base, "lead", None),
        min_workers=ov.min_workers if ov.min_workers is not None
        else base.min_workers,
        max_workers=base.max_workers,
        initial_workers=base.initial_workers
        if base.initial_workers is not None else max(initial, 1),
        headroom=ov.headroom if ov.headroom is not None else base.headroom)


_FEEDBACK_METRIC = {None: "both", "prefill": "ttft", "decode": "atgt"}


def _build_policy(s: ScalingLike, scfg: ScaleSimConfig,
                  spot_spec: Optional[WorkerSpec],
                  side: Optional[str] = None):
    base = _open_loop(s)
    mix = getattr(base, "spot_mix", None)
    if mix is None and spot_spec is not None and spot_spec.is_spot:
        mix = SpotMixConfig(discount=spot_spec.price,
                            hazard=spot_spec.preempt_hazard)
    if isinstance(base, Forecast):
        fc = SeasonalNaiveForecaster(ForecastConfig(
            period=base.period, bin_width=base.bin_width or base.interval))
        inner = ForecastPolicy(scfg, fc, spot_mix=mix)
    else:
        inner = ReactivePolicy(scfg, spot_mix=mix)
    if not isinstance(s, FeedbackScale):
        return inner
    ov = _side_override(s, side)
    metric = ov.metric or (s.metric if s.metric != "auto"
                           else _FEEDBACK_METRIC[side])
    fcfg = FeedbackConfig(
        slo_target=s.slo_target, deadband=s.deadband, boost=s.boost,
        decay=s.decay, max_gain=s.max_gain, min_gain=s.min_gain,
        window=ov.window if ov.window is not None else s.window,
        min_samples=s.min_samples, attack_cooldown=s.attack_cooldown)
    return FeedbackPolicy(inner, fcfg, metric=metric)


# ---- the engine: colocated ---------------------------------------------------


def _run_colocated(sc: Scenario, seed: int) -> RunReport:
    topo_cfg: Colocated = sc.topology
    cfg = SimConfig(heartbeat=topo_cfg.heartbeat, policy=topo_cfg.policy,
                    split_phase=topo_cfg.split_phase,
                    rebalance=topo_cfg.rebalance, gamma=topo_cfg.gamma,
                    theta=topo_cfg.theta, max_batch=topo_cfg.max_batch,
                    seed=seed, router=topo_cfg.router,
                    prefix_cache=topo_cfg.prefix_cache,
                    cache_tokens=topo_cfg.cache_tokens)
    rng = np.random.default_rng(seed)
    pools = sc.fleet.for_role("serve")
    if not pools:
        raise ValueError("colocated scenario needs at least one fleet pool "
                         "(role='serve')")
    tenants = list(sc.tenants) if sc.tenants is not None else None
    dedicated = any(p.tenants is not None for p in pools)
    if dedicated and tenants is None:
        raise ValueError("PoolSpec.tenants names tenants of a multi-tenant "
                         "scenario; set Scenario.tenants")
    lora = tenants is not None and any(t.lora is not None for t in tenants)
    # restricted fleets (dedicated pools / LoRA adapters) fence placement
    # per worker — only meaningful with explicit fixed pool counts
    restricted = dedicated or lora
    sims: Dict[int, SimWorker] = {}
    wid = [0]

    def new_worker(wspec: WorkerSpec):
        wid[0] += 1
        return make_worker_state(wid[0], wspec, cfg, sc.slo)

    market = sc.market
    if market is not None and (market.prefill_spec is not None
                               or len(market.prefill_events) > 0):
        raise ValueError("SpotMarket.prefill_spec/prefill_events describe "
                         "the prefill side of a Disaggregated topology; a "
                         "Colocated scenario would silently ignore them")
    notice = market.notice_s if market is not None else 0.0
    scaling = sc.scaling
    if restricted and not isinstance(scaling, FixedScale):
        raise ValueError("dedicated tenant pools / LoRA adapters need a "
                         "FixedScale fleet (autoscaling policies size one "
                         "undifferentiated pool)")
    if isinstance(scaling, FixedScale):
        if scaling.n is not None:
            src = [(pools[0], pools[0].spec)] * int(scaling.n)
        else:
            src = [(p, p.spec) for p in pools for _ in range(p.count)]
        name_idx = {t.name: i for i, t in enumerate(tenants)} \
            if tenants is not None else {}
        workers = []
        for p, s in src:
            w = new_worker(s)
            if p.tenants is not None:
                unknown = [nm for nm in p.tenants if nm not in name_idx]
                if unknown:
                    raise ValueError(f"PoolSpec.tenants names unknown "
                                     f"tenant(s) {unknown}")
                w.allowed_tenants = frozenset(name_idx[nm]
                                              for nm in p.tenants)
            workers.append(w)
            sims[w.id] = SimWorker(w, w.perf, 0.0, cfg.split_phase)
        factory = None
        if not workers:                # elastic: the min-cost oracle mode
            if restricted:
                raise ValueError("a restricted (dedicated/LoRA) fleet "
                                 "needs explicit pool counts; the elastic "
                                 "oracle opens undifferentiated workers")
            def factory():
                return new_worker(pools[0].spec)
        pool = FixedPool(workers, sims, rng, factory=factory,
                         notice_s=notice)
        scaling_label = "elastic" if factory is not None else "fixed"
    else:
        if isinstance(scaling, PolicyScale):
            policy, scfg = scaling.policy, scaling.scfg
        else:
            scfg = _scale_cfg(scaling, sum(p.count for p in pools))
            policy = _build_policy(
                scaling, scfg, market.spec if market is not None else None)

        def on_spawn(w, t):
            sims[w.id] = SimWorker(w, w.perf, t, cfg.split_phase)

        def on_kill(w):
            sim = sims.pop(w.id)
            if sim.cache is not None:
                sim.cache.vaporize()    # cached prefixes die with the worker
            lost = w.ongoing + w.new_batch + sim.preempted
            for r in lost:
                r.cached_len = 0        # granted reuse is void off-worker
            w.ongoing.clear()
            w.new_batch.clear()
            w.mark_dirty()
            return lost

        pool = ManagedPool(
            pools[0].spec, scfg, policy, cfg.heartbeat, rng,
            new_worker=new_worker, on_spawn=on_spawn, on_kill=on_kill,
            load=lambda w: w.batch_size,
            idle=lambda w: (not w.ongoing and not w.new_batch
                            and not sims[w.id].preempted),
            sims=sims, spot_spec=market.spec if market is not None else None,
            notice_s=notice, name="serve")
        scaling_label = getattr(policy, "name", type(policy).__name__)

    managed = isinstance(pool, ManagedPool)
    topo = ColocatedTopology(sc.slo, cfg, pool, rng, predictor=sc.predictor,
                             observer=sc.observer, tracking=not managed,
                             tenants=tenants)
    topo.restricted = restricted
    trace = sc.materialize()
    trace = run_heartbeat_loop(
        trace, cfg.heartbeat, topo.admit, topo.step, topo.drained,
        events=market.events if market is not None else None, fire=topo.fire)

    rep = RunReport(topology="colocated", scaling=scaling_label,
                    **_percentiles(topo.finished, len(trace), sc.slo))
    rep.moves = topo.moves
    if managed:
        rep.peak_workers = pool.peak
        rep.gpu_seconds = pool.gpu_s
        rep.gpu_cost = pool.gpu_s
        rep.spot_gpu_seconds = pool.spot_gpu_s
        rep.epochs = {"serve": pool.epochs}
    else:
        rep.peak_workers = topo.peak_workers
        # every worker that served counts, including market-reclaimed ones
        # the pool removed mid-run (matches the disagg fixed path, which
        # reports declared pool counts)
        rep.gpu_cost = sum(w.spec.n_accelerators for w in pool.workers) \
            + pool.retired_cost
    rep.preempted_workers = pool.killed
    rep.drained_ok = pool.drained_ok
    rep.requeued = pool.requeued
    rep.cache_hit_rate = topo.cache_stats.hit_rate()
    rep.prefix_evictions = topo.cache_stats.evictions
    if tenants is not None:
        # the multi-tenant headline judges every request against its OWN
        # tenant SLO (identical to the scalar number for one tenant, whose
        # budgets equal the planning SLO)
        rep.attainment = tenant_attainment(trace)
        rep.tenant_rows = tenant_rows(trace, tenants, rep.gpu_cost)
        rep.lora_swaps = topo.lora_swaps
    return rep


# ---- the engine: disaggregated -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class _SideEvent:
    """A market reclaim event routed to one side of a disaggregated
    cluster (the heartbeat loop only needs the ``t`` attribute)."""
    t: float
    ev: object
    side: str


def _merge_side_events(market: Optional[SpotMarket]):
    if market is None:
        return None
    evs = [_SideEvent(e.t, e, "decode") for e in market.events] \
        + [_SideEvent(e.t, e, "prefill") for e in market.prefill_events]
    return evs or None


def _run_disagg(sc: Scenario, seed: int) -> RunReport:
    topo_cfg: Disaggregated = sc.topology
    cfg = DisaggConfig(heartbeat=topo_cfg.heartbeat, policy=topo_cfg.policy,
                       gamma=topo_cfg.gamma, theta=topo_cfg.theta,
                       kv_transfer_bw=topo_cfg.kv_transfer_bw,
                       kv_transfer_lat=topo_cfg.kv_transfer_lat, seed=seed,
                       prefill_router=topo_cfg.prefill_router,
                       decode_router=topo_cfg.decode_router)
    rng = np.random.default_rng(seed)
    p_pools = [(p.spec, p.count) for p in sc.fleet.for_role("prefill")]
    d_pools = [(p.spec, p.count) for p in sc.fleet.for_role("decode")]
    if not p_pools or not d_pools:
        raise ValueError("disaggregated scenario needs fleet pools with "
                         "role='prefill' and role='decode'")
    if isinstance(sc.scaling, FixedScale):
        # legacy _as_pools semantics: zero-count pool types do not exist
        # (they would pollute worker ids and the pool_mix label)
        p_pools = [(s, k) for s, k in p_pools if k > 0]
        d_pools = [(s, k) for s, k in d_pools if k > 0]
        if not p_pools or not d_pools:
            raise ValueError("fixed disaggregated scenario has an empty "
                             "prefill or decode pool (all counts are 0)")
    market = sc.market
    notice = market.notice_s if market is not None else 0.0
    scaling = sc.scaling

    if isinstance(scaling, FixedScale):
        if scaling.n is not None:
            raise ValueError("FixedScale.n is ambiguous for a disaggregated "
                             "fleet; set per-pool counts instead")
        # prefill groups: ids dense from 1; decode groups: ids from 1000
        pools_p: List[Tuple[WorkerSpec, List[PrefillSimWorker]]] = []
        wid = 0
        for spec, k in p_pools:
            group = []
            for _ in range(k):
                wid += 1
                group.append(PrefillSimWorker(wid, spec, sc.slo))
            pools_p.append((spec, group))
        dcfg = SimConfig(gamma=cfg.gamma, theta=cfg.theta, split_phase=True)
        pools_d: List[Tuple[WorkerSpec, List]] = []
        sims_d: Dict[int, SimWorker] = {}
        wid = 1000
        for spec, k in d_pools:
            group = []
            for _ in range(k):
                w = make_worker_state(wid, spec, dcfg, sc.slo)
                group.append(w)
                sims_d[w.id] = SimWorker(w, w.perf, 0.0, split_phase=True)
                wid += 1
            pools_d.append((spec, group))
        prefill = FixedPrefillSide(pools_p, rng=rng, notice_s=notice)
        decode = FixedDecodeSide(pools_d, sims_d, rng=rng, notice_s=notice)
        scaling_label = "fixed"
    else:
        if isinstance(scaling, PolicyScale):
            raise ValueError("PolicyScale wraps one policy instance; a "
                             "disaggregated scenario scales each side with "
                             "its own — use Reactive(...) or Forecast(...)")
        if len(p_pools) != 1 or len(d_pools) != 1:
            raise ValueError("autoscaled disaggregation supports one worker "
                             "type per side (plus its spot twin)")
        p_spec, p_n = p_pools[0]
        d_spec, d_n = d_pools[0]
        spot_d = market.spec if market is not None else None
        spot_p = market.prefill_spec if market is not None else None
        scfg_p = _scale_cfg(scaling, p_n, side="prefill")
        scfg_d = _scale_cfg(scaling, d_n, side="decode")
        pol_p = _build_policy(scaling, scfg_p, spot_p, side="prefill")
        pol_d = _build_policy(scaling, scfg_d, spot_d, side="decode")
        wid_p = [0]

        def new_prefill(wspec: WorkerSpec) -> PrefillSimWorker:
            wid_p[0] += 1
            return PrefillSimWorker(wid_p[0], wspec, sc.slo)

        def spawn_prefill(w, t):
            w.t = t

        def kill_prefill(w):
            lost = list(w.queue)
            w.queue.clear()
            w.pending_tokens = 0
            return lost

        pool_p = ManagedPool(
            p_spec, scfg_p, pol_p, cfg.heartbeat, rng,
            new_worker=new_prefill, on_spawn=spawn_prefill,
            on_kill=kill_prefill, load=lambda w: len(w.queue),
            idle=lambda w: not w.queue, mark=mark_requeue,
            spot_spec=spot_p, notice_s=notice, name="prefill")

        dcfg = SimConfig(gamma=cfg.gamma, theta=cfg.theta, split_phase=True)
        sims_d = {}
        wid_d = [100000]

        def new_decode(wspec: WorkerSpec):
            wid_d[0] += 1
            return make_worker_state(wid_d[0], wspec, dcfg, sc.slo)

        def spawn_decode(w, t):
            sims_d[w.id] = SimWorker(w, w.perf, t, split_phase=True)

        def kill_decode(w):
            sim = sims_d.pop(w.id)
            lost = w.ongoing + w.new_batch + sim.preempted
            w.ongoing.clear()
            w.new_batch.clear()
            w.mark_dirty()
            return lost

        pool_d = ManagedPool(
            d_spec, scfg_d, pol_d, cfg.heartbeat, rng,
            new_worker=new_decode, on_spawn=spawn_decode,
            on_kill=kill_decode, load=lambda w: w.batch_size,
            idle=lambda w: (not w.ongoing and not w.new_batch
                            and not sims_d[w.id].preempted),
            sims=sims_d, spot_spec=spot_d, notice_s=notice, name="decode")
        prefill = ManagedSide(pool_p, p_spec)
        decode = ManagedSide(pool_d, d_spec)
        scaling_label = getattr(pol_d, "name", type(pol_d).__name__)

    topo = DisaggTopology(sc.slo, cfg, prefill, decode, rng,
                          predictor=sc.predictor, observer=sc.observer)
    trace = sc.materialize()
    trace = run_heartbeat_loop(
        trace, cfg.heartbeat, topo.admit, topo.step, topo.drained,
        events=_merge_side_events(market), fire=topo.fire)

    rep = RunReport(topology="disaggregated", scaling=scaling_label,
                    **_percentiles(topo.finished, len(trace), sc.slo))
    rep.mean_transfer = float(np.mean(topo.transfers)) if topo.transfers \
        else 0.0
    rep.kv_retransfers = topo.kv_retransfers
    if isinstance(scaling, FixedScale):
        rep.n_prefill = sum(k for _, k in p_pools)
        rep.n_decode = sum(k for _, k in d_pools)
        rep.peak_workers = rep.n_prefill + rep.n_decode
        rep.gpu_cost = pool_cost(p_pools) + pool_cost(d_pools)
        p_label = ",".join(f"{s.name}x{k}" for s, k in p_pools)
        d_label = ",".join(f"{s.name}x{k}" for s, k in d_pools)
        rep.pool_mix = f"p:{p_label}|d:{d_label}"
    else:
        rep.n_prefill = prefill.pool.peak
        rep.n_decode = decode.pool.peak
        rep.peak_workers = rep.n_prefill + rep.n_decode
        rep.gpu_seconds = prefill.gpu_s + decode.gpu_s
        rep.gpu_cost = rep.gpu_seconds
        rep.spot_gpu_seconds = prefill.spot_gpu_s + decode.spot_gpu_s
        rep.pool_mix = (f"p:{p_pools[0][0].name}~auto|"
                        f"d:{d_pools[0][0].name}~auto")
        rep.epochs = {"prefill": prefill.epochs, "decode": decode.epochs}
    rep.preempted_workers = prefill.killed + decode.killed
    rep.drained_ok = prefill.drained_ok + decode.drained_ok
    rep.requeued = prefill.requeued + decode.requeued
    return rep


# ---- the two verbs -----------------------------------------------------------


def run(scenario: Scenario, seed: Optional[int] = None) -> RunReport:
    """Execute one scenario and return its :class:`RunReport`.

    ``seed`` overrides ``scenario.seed`` (placement tie-breaking and reclaim
    victim choice). A callable workload is materialized fresh per call; a
    concrete trace is simulated in place (its requests carry the outcome),
    exactly like the legacy entry points."""
    s = seed if seed is not None else scenario.seed
    scenario = resolve_scenario(scenario)
    if isinstance(scenario.topology, Colocated):
        if scenario.engine == "vectorized":
            from repro_torch.serving import fastsim
            return fastsim.run_colocated_vectorized(scenario, s)
        if scenario.engine == "jax":
            from repro_torch.serving import fastsim_jax
            return fastsim_jax.run_colocated_jax(scenario, s)
        if scenario.engine != "reference":
            raise ValueError(f"unknown engine {scenario.engine!r} (expected "
                             "'reference', 'vectorized' or 'jax')")
        return _run_colocated(scenario, s)
    if scenario.engine != "reference":
        raise ValueError("engine='vectorized'/'jax' accelerate Colocated "
                         "topologies only; a "
                         f"{type(scenario.topology).__name__} scenario "
                         "needs engine='reference'")
    if isinstance(scenario.topology, Disaggregated):
        return _run_disagg(scenario, s)
    raise TypeError(f"unknown topology {type(scenario.topology).__name__}")


def optimize(scenario: Scenario, objective: str = "cost", *,
             attain_target: float = 0.99, lo: int = 1, hi: int = 512,
             fleet_fn: Optional[Callable[[int], Sequence[WorkerSpec]]] = None,
             max_prefill: int = 8, hi_decode: int = 64,
             prefill_pool_fn: Optional[Callable] = None,
             decode_pool_fn: Optional[Callable] = None,
             prefill_mix: Optional[Sequence[WorkerSpec]] = None,
             decode_mix: Optional[Sequence[WorkerSpec]] = None,
             ratio_grid: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
             policy_space: Optional[Dict[str, Sequence]] = None,
             max_rounds: int = 3) -> Plan:
    """Search the cheapest scenario meeting ``attain_target``.

    For a **FixedScale** scenario this sizes the fleet — one verb subsuming
    the legacy ``min_workers_for_slo`` (binary search over the colocated
    worker count, with the plateau-infeasibility diagnosis) and
    ``min_cost_disagg`` (the joint (n_prefill, n_decode) frontier walk,
    including heterogeneous pool fns and the ratio search).

    For an **autoscaled** scenario (``Reactive``/``Forecast``/
    ``FeedbackScale``) the worker counts belong to the policy, so the
    search runs over the *policy parameters* instead: coordinate descent on
    ``policy_space`` — axis name -> candidate values, defaulting to
    headroom x theta x spot ``max_spot_frac`` x per-side leads (see
    ``default_policy_space``) — keeping the cheapest attaining assignment
    (or the highest-attaining one when nothing reaches the target). The
    returned ``Plan.scenario`` re-runs to exactly the searched report
    (``Plan.params`` names the winning assignment).

    Either way the workload is materialized ONCE — a trace factory is
    evaluated a single time and every candidate replays a clone of the same
    request list (``workload.clone_trace``), so the search compares
    candidates on the same arrivals instead of implicitly re-sampling.

    ``fleet_fn(n)`` (colocated) maps a worker count to a heterogeneous
    fleet; ``prefill_pool_fn``/``decode_pool_fn``/``prefill_mix``/
    ``decode_mix``/``ratio_grid`` (disaggregated) are the pool-mix hooks of
    the legacy frontier."""
    if objective != "cost":
        raise ValueError(f"unsupported objective {objective!r} (only 'cost')")
    if isinstance(scenario.scaling, PolicyScale):
        raise ValueError("optimize() cannot search a PolicyScale escape "
                         "hatch (the policy instance is prebuilt); declare "
                         "the scaling as Reactive/Forecast/FeedbackScale")
    scenario = resolve_scenario(scenario)
    template = scenario.materialize()
    if not isinstance(scenario.scaling, FixedScale):
        return _optimize_policy(scenario, template, attain_target,
                                policy_space, max_rounds)
    if policy_space is not None:
        raise ValueError("policy_space searches autoscaled scenarios; a "
                         "FixedScale scenario has no scaling policy to tune")
    if scenario.tenants is not None and len(scenario.tenants) > 1:
        if fleet_fn is not None:
            raise ValueError("fleet_fn and the multi-tenant pool-partition "
                             "search are mutually exclusive")
        return _optimize_tenants(scenario, template, attain_target, lo, hi)
    if isinstance(scenario.topology, Colocated):
        return _optimize_colocated(scenario, template, attain_target, lo, hi,
                                   fleet_fn)
    return _optimize_disagg(scenario, template, attain_target, max_prefill,
                            hi_decode, prefill_pool_fn, decode_pool_fn,
                            prefill_mix, decode_mix, ratio_grid)


# ---- the policy-space search (autoscaled scenarios) --------------------------


def default_policy_space(scenario: Scenario) -> Dict[str, Sequence]:
    """The default coordinate-descent axes for an autoscaled scenario:
    capacity headroom and placement strictness always; the spot capacity
    share when a market exists; per-side look-ahead leads when the
    topology is disaggregated (prefill wants a short lead — TTFT burns in
    the arrival hop — decode a longer one)."""
    space: Dict[str, Sequence] = {
        "headroom": (1.0, 1.1, 1.2, 1.35, 1.5),
        "theta": (0.7, 0.8, 0.9),
    }
    if scenario.market is not None:
        space["max_spot_frac"] = (0.0, 0.35, 0.7)
    if isinstance(scenario.topology, Disaggregated) \
            and isinstance(_open_loop(scenario.scaling), Forecast):
        # lead is a forecast look-ahead; ReactivePolicy never reads it, so
        # searching it under a reactive base would burn evals on a dead knob
        space["prefill_lead"] = (5.0, 10.0, 15.0)
        space["decode_lead"] = (15.0, 20.0, 30.0)
    return space


def _with_side_lead(s, side: str, value: float):
    ov = getattr(s, side, None) or SideOverride()
    return dataclasses.replace(s, **{side: dataclasses.replace(ov,
                                                               lead=value)})


def _scaling_with_axis(s: ScalingLike, name: str, value,
                       market: Optional[SpotMarket]) -> ScalingLike:
    """One open-loop scaling declaration with a policy axis applied.
    ``FeedbackScale`` axes route to its base — the feedback controller
    corrects whatever open loop the search proposes."""
    if isinstance(s, FeedbackScale):
        return dataclasses.replace(
            s, base=_scaling_with_axis(s.base, name, value, market))
    if name == "headroom":
        return dataclasses.replace(s, headroom=value)
    if name == "max_spot_frac":
        mix = s.spot_mix
        if mix is None:
            spec = market.spec if market is not None else None
            mix = SpotMixConfig(discount=spec.price,
                                hazard=spec.preempt_hazard) \
                if spec is not None and spec.is_spot else SpotMixConfig()
        return dataclasses.replace(
            s, spot_mix=dataclasses.replace(mix, max_spot_frac=value))
    if name == "prefill_lead":
        return _with_side_lead(s, "prefill", value)
    if name == "decode_lead":
        return _with_side_lead(s, "decode", value)
    raise ValueError(f"unknown policy axis {name!r}")


def _apply_assignment(scenario: Scenario,
                      assign: Dict[str, object]) -> Scenario:
    sc = scenario
    for name, value in assign.items():
        if name == "theta":
            sc = dataclasses.replace(
                sc, topology=dataclasses.replace(sc.topology, theta=value))
        else:
            sc = dataclasses.replace(
                sc, scaling=_scaling_with_axis(sc.scaling, name, value,
                                               sc.market))
    return sc


def _attains(rep: RunReport, attain_target: float,
             tenants: Optional[Sequence[TenantSpec]] = None) -> bool:
    """The optimize() feasibility test. Scalar scenarios: headline
    attainment >= target with nothing left unfinished. Multi-tenant
    scenarios: EVERY tenant's per-tenant attainment must reach its own
    target (``TenantSpec.attain_target`` overrides the argument). When an
    engine path yields no per-tenant rows (batched jax candidates do not
    write the trace back), the headline — judged against the strictest
    planning SLO — stands in, compared against the strictest target."""
    if rep.finished != rep.total:
        return False
    if tenants is not None:
        targets = [t.attain_target if t.attain_target is not None
                   else attain_target for t in tenants]
        if len(rep.tenant_rows) == len(tenants):
            return all(row["attainment"] >= tg
                       for row, tg in zip(rep.tenant_rows, targets))
        return rep.attainment >= max(targets)
    return rep.attainment >= attain_target


def _optimize_policy(scenario: Scenario, template, attain_target: float,
                     policy_space: Optional[Dict[str, Sequence]],
                     max_rounds: int) -> Plan:
    space = policy_space if policy_space is not None \
        else default_policy_space(scenario)
    if not space:
        raise ValueError("policy_space is empty: nothing to search")
    evals = [0]
    cache: Dict[Tuple, RunReport] = {}

    def key(assign: Dict) -> Tuple:
        # key on the *effective* configuration, not the assignment dict: an
        # axis value equal to the scenario's declared one (e.g. headroom=1.0
        # on a default scenario) must hit the baseline's cache entry instead
        # of replaying an identical simulation
        sc = _apply_assignment(scenario, assign)
        return repr(sc.scaling), repr(sc.topology)

    def evaluate(assign: Dict) -> RunReport:
        k = key(assign)
        rep = cache.get(k)
        if rep is None:
            sc = _apply_assignment(
                dataclasses.replace(scenario,
                                    workload=clone_trace(template)), assign)
            rep = run(sc)
            cache[k] = rep
            evals[0] += 1
        return rep

    def prefetch(assigns: Sequence[Dict]) -> None:
        """On the jax engine, fill the cache for one coordinate's whole
        candidate bracket with a single lockstep-batched compiled call
        (``run_policy_candidate_batch``) instead of one run per value."""
        if scenario.engine != "jax" \
                or not isinstance(scenario.topology, Colocated):
            return
        seen = set()
        uniq = []
        for a in assigns:
            k = key(a)
            if k not in cache and k not in seen:
                seen.add(k)
                uniq.append((k, a))
        if len(uniq) < 2:       # nothing to batch
            return
        from repro_torch.serving import fastsim_jax
        scs = [_apply_assignment(
            dataclasses.replace(scenario, workload=clone_trace(template)),
            a) for _, a in uniq]
        for (k, _a), rep in zip(uniq,
                                fastsim_jax.run_policy_candidate_batch(scs)):
            cache[k] = rep
            evals[0] += 1

    def attains(rep: RunReport) -> bool:
        return _attains(rep, attain_target, scenario.tenants)

    def better(cand: RunReport, best: RunReport) -> bool:
        if attains(cand) != attains(best):
            return attains(cand)
        if attains(cand):                  # both attain: cheaper wins
            return cand.gpu_cost < best.gpu_cost
        if cand.attainment != best.attainment:
            return cand.attainment > best.attainment
        return cand.gpu_cost < best.gpu_cost

    current: Dict[str, object] = {}
    best = evaluate(current)
    for _ in range(max_rounds):
        improved = False
        for name, values in space.items():
            prefetch([dict(current, **{name: v}) for v in values
                      if current.get(name) != v])
            for v in values:
                if current.get(name) == v:
                    continue
                cand = dict(current)
                cand[name] = v
                rep = evaluate(cand)
                if better(rep, best):
                    best, current = rep, cand
                    improved = True
        if not improved:
            break
    win = _apply_assignment(
        dataclasses.replace(scenario,
                            workload=lambda: clone_trace(template)), current)
    return Plan(objective="cost", scenario=win, report=best,
                n_workers=best.peak_workers, cost=best.gpu_cost,
                evals=evals[0], params=dict(current))


def _optimize_colocated(scenario: Scenario, template, attain_target: float,
                        lo: int, hi: int, fleet_fn) -> Plan:
    pools = scenario.fleet.for_role("serve")
    if not pools:
        raise ValueError("optimize needs a fleet pool to size")
    base_spec = pools[0].spec
    reports: Dict[int, RunReport] = {}
    evals = [0]
    attain_hist: List[Tuple[int, float]] = []

    def scenario_for(n: int) -> Scenario:
        if fleet_fn is not None:
            fleet = FleetSpec([PoolSpec(s, 1) for s in fleet_fn(n)])
        else:
            fleet = FleetSpec([PoolSpec(base_spec, n)])
        return dataclasses.replace(scenario, workload=clone_trace(template),
                                   fleet=fleet, scaling=FixedScale())

    def evaluate(ns: Sequence[int]) -> None:
        """Evaluate candidate worker counts into ``reports``. On the jax
        engine a whole batch runs as ONE vmapped compiled call; the other
        engines sweep sequentially (the vectorized core still being far
        cheaper per candidate than the reference)."""
        ns = [n for n in ns if n not in reports]
        if not ns:
            return
        multi = scenario.tenants is not None and len(scenario.tenants) > 1
        if scenario.engine == "jax" and fleet_fn is None and not multi \
                and len(ns) > 1:
            from repro_torch.serving import fastsim_jax
            batch = fastsim_jax.run_candidate_batch(
                [scenario_for(n) for n in ns])
            for n, rep in zip(ns, batch):
                reports[n] = rep
            evals[0] += len(ns)
        else:
            for n in ns:
                reports[n] = run(scenario_for(n))
                evals[0] += 1

    def ok(n: int) -> bool:
        if n not in reports:
            evaluate([n])
        rep = reports[n]
        attain_hist.append((n, rep.attainment))
        return _attains(rep, attain_target, scenario.tenants)

    escalations = 0
    while not ok(hi):
        # plateau detection: if doubling workers stops improving attainment,
        # the residual violations are scale-invariant (e.g. prediction-error
        # preemption tails) — the target is infeasible, not under-provisioned
        if len(attain_hist) >= 2 and \
                attain_hist[-1][1] <= attain_hist[-2][1] + 1e-3:
            raise RuntimeError(
                f"attainment plateaus at {attain_hist[-1][1]:.3f} < "
                f"{attain_target} (scale-invariant violations)")
        hi *= 2
        escalations += 1
        if hi > 8192 or escalations > 6:
            raise RuntimeError("workload cannot meet SLO at any scale")
    # multisection on the batch-capable engines: probe a whole bracket per
    # round (one compiled call on jax) instead of one midpoint at a time
    batch_k = 8 if scenario.engine in ("vectorized", "jax") else 1
    while lo < hi:
        if batch_k > 1 and hi - lo > 2:
            span = hi - lo
            cand = sorted({lo + (span * i) // (batch_k + 1)
                           for i in range(1, batch_k + 1)})
            cand = [c for c in cand if lo <= c < hi]
            evaluate(cand)
            for c in cand:              # monotone: walk the probe results
                if ok(c):
                    hi = c
                    break
                lo = c + 1
            continue
        mid = (lo + hi) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid + 1
    rep = reports.get(lo)
    if rep is None:                     # lo was proven by its neighbors only
        evaluate([lo])
        rep = reports[lo]
    return Plan(objective="cost", scenario=scenario_for(lo), report=rep,
                n_workers=lo, cost=rep.gpu_cost, evals=evals[0])


def _tenant_partitions(n: int, tenants) -> List[List[Tuple[int, ...]]]:
    """Candidate pool partitions of the tenant index set: for <= 4 tenants
    every set partition (Bell numbers stay tiny: B(4) = 15); beyond that,
    the three canonical assignments — fully shared, fully dedicated, and
    one pool per tier."""
    if n <= 4:
        parts: List[List[Tuple[int, ...]]] = []

        def rec(i: int, groups: List[List[int]]) -> None:
            if i == n:
                parts.append([tuple(g) for g in groups])
                return
            for g in groups:
                g.append(i)
                rec(i + 1, groups)
                g.pop()
            groups.append([i])
            rec(i + 1, groups)
            groups.pop()

        rec(0, [])
        return parts
    shared = [tuple(range(n))]
    dedicated = [(i,) for i in range(n)]
    tiers: Dict[str, List[int]] = {}
    for i, t in enumerate(tenants):
        tiers.setdefault(t.tier, []).append(i)
    by_tier = [tuple(v) for v in tiers.values()]
    cands = [shared, dedicated]
    if by_tier not in cands:
        cands.append(by_tier)
    return cands


def _optimize_tenants(scenario: Scenario, template, attain_target: float,
                      lo: int, hi: int) -> Plan:
    """The joint multi-tenant placement search: which tenants *share* a
    pool versus get a dedicated one, and how many workers each pool gets,
    subject to EVERY tenant reaching its attainment target.

    Dedicated pools do not interact — placement is fenced per pool and
    rebalance is disabled on restricted fleets — so each group of a
    candidate partition is sized independently with the scalar binary
    search on the group's merged sub-trace, groups are cached across
    partitions (the singleton {k} appears in many partitions), and the
    cheapest feasible partition wins. The winning plan's fleet records the
    pool->tenant assignment (``PoolSpec.tenants``; the fully-shared
    partition keeps one undifferentiated pool) and a final combined run —
    on the reference engine when the fleet is restricted — verifies the
    joint scenario and supplies the per-tenant report."""
    tenants = list(scenario.tenants)
    pools = scenario.fleet.for_role("serve")
    if not pools:
        raise ValueError("optimize needs a fleet pool to size")
    base_spec = pools[0].spec
    group_plans: Dict[Tuple[int, ...], Plan] = {}

    def size_group(group: Tuple[int, ...]) -> Plan:
        plan = group_plans.get(group)
        if plan is None:
            specs = [tenants[i] for i in group]
            remap = {g: i for i, g in enumerate(group)}
            sub = clone_trace([r for r in template if r.tenant in remap])
            for r in sub:
                r.tenant = remap[r.tenant]
            sub_sc = resolve_scenario(dataclasses.replace(
                scenario, workload=sub, slo=None, tenants=specs))
            if any(s.lora is not None for s in specs):
                # LoRA residency/swap modeling lives in the reference
                # engine; the compiled envelopes reject it
                sub_sc = dataclasses.replace(sub_sc, engine="reference")
            try:
                plan = _optimize_colocated(sub_sc, sub, attain_target,
                                           lo, hi, None)
            except RuntimeError:
                # this group cannot attain at any size (plateau / cap) —
                # the partition is infeasible, not the whole search
                plan = Plan(objective="cost", scenario=None, report=None)
            group_plans[group] = plan
        return plan

    best_part: Optional[List[Tuple[int, ...]]] = None
    best_cost = math.inf
    best_plans: Optional[List[Plan]] = None
    for part in _tenant_partitions(len(tenants), tenants):
        plans = [size_group(g) for g in part]
        if not all(p.feasible for p in plans):
            continue
        cost = sum(p.cost for p in plans)
        if cost < best_cost:
            best_part, best_cost, best_plans = part, cost, plans
    n_evals = sum(p.evals for p in group_plans.values())
    if best_part is None:
        return Plan(objective="cost", scenario=None, report=None,
                    evals=n_evals)
    fleet = FleetSpec([
        PoolSpec(base_spec, p.n_workers,
                 tenants=([tenants[i].name for i in g]
                          if len(best_part) > 1 else None))
        for g, p in zip(best_part, best_plans)])
    win = dataclasses.replace(scenario, workload=clone_trace(template),
                              fleet=fleet, scaling=FixedScale())
    if len(best_part) > 1 or any(t.lora is not None for t in tenants):
        # restricted fleets (dedicated pools / LoRA) run on the reference
        # engine only
        win = dataclasses.replace(win, engine="reference")
    rep = run(win)
    n_evals += 1
    win = dataclasses.replace(win, workload=lambda: clone_trace(template))
    return Plan(objective="cost", scenario=win, report=rep,
                n_workers=sum(p.n_workers for p in best_plans),
                cost=rep.gpu_cost, evals=n_evals,
                params={"pools": [tuple(tenants[i].name for i in g)
                                  for g in best_part]})


def _optimize_disagg(scenario: Scenario, template, attain_target: float,
                     max_prefill: int, hi_decode: int, prefill_pool_fn,
                     decode_pool_fn, prefill_mix, decode_mix,
                     ratio_grid) -> Plan:
    p_specs = scenario.fleet.for_role("prefill")
    d_specs = scenario.fleet.for_role("decode")
    prefill_spec = p_specs[0].spec if p_specs else None
    decode_spec = d_specs[0].spec if d_specs else None
    evals = [0]
    # id(report) -> (report, pools): the stored report reference keeps the
    # object alive, so the id key can never be recycled by a later eval
    winners: Dict[int, Tuple] = {}

    def run_pools(pp, dp) -> RunReport:
        fleet = FleetSpec([PoolSpec(s, k, role="prefill") for s, k in pp]
                          + [PoolSpec(s, k, role="decode") for s, k in dp])
        sc = dataclasses.replace(scenario, workload=clone_trace(template),
                                 fleet=fleet, scaling=FixedScale())
        evals[0] += 1
        rep = run(sc)
        winners[id(rep)] = (rep, pp, dp)
        return rep

    def attains(rep: RunReport) -> bool:
        return rep.attainment >= attain_target and rep.finished == rep.total

    def frontier(pf, df, best: Optional[RunReport]) -> Optional[RunReport]:
        min_decode_cost = pool_cost(df(1))
        for n_p in range(1, max_prefill + 1):
            if best is not None and \
                    pool_cost(pf(n_p)) + min_decode_cost >= best.gpu_cost:
                break                  # every remaining point costs more
            lo, hi = 1, hi_decode
            res_hi = run_pools(pf(n_p), df(hi))
            if not attains(res_hi):
                continue               # prefill pool too small at any scale
            best_np = res_hi
            while lo < hi:
                mid = (lo + hi) // 2
                res = run_pools(pf(n_p), df(mid))
                if attains(res):
                    best_np, hi = res, mid
                else:
                    lo = mid + 1
            if best is None or best_np.gpu_cost < best.gpu_cost:
                best = best_np
        return best

    best: Optional[RunReport] = None
    if prefill_mix is not None or decode_mix is not None:
        pmix = list(prefill_mix) if prefill_mix is not None \
            else [prefill_spec]
        dmix = list(decode_mix) if decode_mix is not None else [decode_spec]
        if any(s is None for s in pmix + dmix):
            raise ValueError("mix search needs specs on both sides "
                             "(a spec list or a fleet pool per role)")
        p_ratios = tuple(ratio_grid) if len(pmix) == 2 else (1.0,)
        d_ratios = tuple(ratio_grid) if len(dmix) == 2 else (1.0,)
        for rp in p_ratios:
            for rd in d_ratios:
                best = frontier(ratio_pool_fn(pmix, rp),
                                ratio_pool_fn(dmix, rd), best)
    else:
        if prefill_pool_fn is None and prefill_spec is None:
            raise ValueError("optimize needs prefill/decode fleet pools or "
                             "pool fns")
        pf = prefill_pool_fn or (lambda n: [(prefill_spec, n)])
        df = decode_pool_fn or (lambda n: [(decode_spec, n)])
        best = frontier(pf, df, None)

    if best is None:
        return Plan(objective="cost", scenario=None, report=None,
                    evals=evals[0])
    _, pp, dp = winners[id(best)]
    fleet = FleetSpec([PoolSpec(s, k, role="prefill") for s, k in pp]
                      + [PoolSpec(s, k, role="decode") for s, k in dp])
    win = dataclasses.replace(scenario, fleet=fleet, scaling=FixedScale())
    return Plan(objective="cost", scenario=win, report=best,
                n_workers=best.n_prefill + best.n_decode,
                cost=best.gpu_cost, evals=evals[0])


__all__ = [
    "Colocated", "Disaggregated", "FeedbackScale", "FixedScale", "FleetSpec",
    "Forecast", "Plan", "PolicyScale", "PoolSpec", "Reactive", "RunReport",
    "Scenario", "SideOverride", "SpotMarket", "TenantSpec", "optimize",
    "run",
]
