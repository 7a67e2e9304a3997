"""Workload generation: ShareGPT-like length distributions + Poisson arrivals.

The real ShareGPT dump is not redistributable inside this container; we use a
lognormal fit matching its published summary statistics (median prompt ~50
tokens with a heavy tail clipped at the 4k context, outputs ~200 median,
weakly correlated with prompt length — cf. the paper's Fig. 2, where output
CDFs shift only slightly across prompt-length bins)."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.request import Request


@dataclasses.dataclass
class WorkloadConfig:
    mean_rate: float = 2.0              # requests / second (Poisson)
    duration: float = 60.0              # seconds
    max_context: int = 4096
    in_mu: float = 4.2                  # ln-space prompt mean (~66 median)
    in_sigma: float = 1.3
    out_mu: float = 5.1                 # ~164 median
    out_sigma: float = 0.9
    out_in_corr: float = 0.15           # mild coupling of ln-lengths
    tail_frac: float = 0.0              # fraction of Pareto-tail outputs
    tail_alpha: float = 1.5             # Pareto shape (lower = heavier)
    seed: int = 0


def sample_lengths(cfg: WorkloadConfig, n: int, rng=None):
    rng = rng or np.random.default_rng(cfg.seed)
    z1 = rng.standard_normal(n)
    z2 = cfg.out_in_corr * z1 + np.sqrt(1 - cfg.out_in_corr ** 2) \
        * rng.standard_normal(n)
    l_in = np.exp(cfg.in_mu + cfg.in_sigma * z1).astype(np.int64)
    l_out = np.exp(cfg.out_mu + cfg.out_sigma * z2).astype(np.int64)
    if cfg.tail_frac > 0:
        # heavy-tail mixture: a Pareto(α) share of outputs models the long
        # agentic/code generations the lognormal body under-represents
        tail = rng.random(n) < cfg.tail_frac
        pareto = (np.exp(cfg.out_mu)
                  * (1.0 + rng.pareto(cfg.tail_alpha, n))).astype(np.int64)
        l_out = np.where(tail, pareto, l_out)
    l_in = np.clip(l_in, 4, cfg.max_context // 2)
    l_out = np.clip(l_out, 4, cfg.max_context // 2)
    return l_in, l_out


def clone_trace(trace) -> List[Request]:
    """Replay a materialized workload: fresh ``Request`` objects carrying
    the same immutable draw (l_in, l_real, arrival) and none of the per-run
    mutable state. This is how ``api.optimize`` evaluates every candidate
    fleet against the *same* arrivals — the workload is sampled once and
    cloned per simulation, instead of implicitly re-sampled via a trace
    factory."""
    return [Request(l_in=r.l_in, l_pred=0, l_real=r.l_real,
                    arrival=r.arrival, tenant=r.tenant,
                    priority=r.priority, slo_ttft=r.slo_ttft,
                    slo_atgt=r.slo_atgt, session_id=r.session_id,
                    turn=r.turn, prefix_len=r.prefix_len) for r in trace]


def mixture_trace(tenant_traces) -> List[Request]:
    """Merge per-tenant arrival streams into one trace, tagging every
    request with its tenant index.

    ``tenant_traces`` is a sequence of per-tenant request lists (already
    materialized). Each request's ``tenant`` field is set to its stream's
    position in ``tenant_traces``; the merged trace is ordered by arrival
    time with a stable, documented tie-break: at equal arrival times, the
    lower tenant index comes first, and within one tenant the original
    stream order is preserved. The merge is a pure reorder of the input
    objects — deterministic for a given input, so a merged trace replays
    identically across all three engines and across reseeds of the
    underlying per-tenant generators."""
    merged: List[Request] = []
    for k, trace in enumerate(tenant_traces):
        for r in trace:
            r.tenant = k
            merged.append(r)
    # sorted() is stable, so equal arrivals keep concatenation order:
    # the effective key is (arrival, tenant index, within-tenant position)
    merged.sort(key=lambda r: r.arrival)
    return merged


def generate_trace(cfg: WorkloadConfig,
                   rate: Optional[float] = None) -> List[Request]:
    """Poisson arrival stream with sampled (l_in, l_real) per request."""
    rng = np.random.default_rng(cfg.seed)
    rate = rate if rate is not None else cfg.mean_rate
    scale = 1.0 / max(rate, 1e-9)
    n = max(int(rate * cfg.duration * 1.5), 16)
    gaps = rng.exponential(scale, n)
    # keep drawing until the stream covers the whole horizon — a fixed
    # draw silently truncates the trace tail on unlucky seeds (same bug
    # class nonhomogeneous_trace guards against)
    while gaps.sum() < cfg.duration:
        gaps = np.concatenate([gaps, rng.exponential(scale, n)])
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < cfg.duration]
    l_in, l_out = sample_lengths(cfg, len(arrivals), rng)
    return [Request(l_in=int(a), l_pred=0, l_real=int(b), arrival=float(t))
            for a, b, t in zip(l_in, l_out, arrivals)]


def nonhomogeneous_trace(cfg: WorkloadConfig,
                         rate_fn: Callable[[float], float],
                         rate_max: float) -> List[Request]:
    """Non-homogeneous Poisson arrivals via Lewis-Shedler thinning: draw a
    homogeneous stream at rate_max, keep each point with probability
    rate_fn(t) / rate_max."""
    rng = np.random.default_rng(cfg.seed)
    scale = 1.0 / max(rate_max, 1e-9)
    chunk = max(int(rate_max * cfg.duration * 1.5), 16)
    gaps = rng.exponential(scale, chunk)
    # keep drawing until the candidate stream covers the whole horizon —
    # a fixed draw silently truncates the trace tail on unlucky seeds
    while gaps.sum() < cfg.duration:
        gaps = np.concatenate([gaps, rng.exponential(scale, chunk)])
    cand = np.cumsum(gaps)
    cand = cand[cand < cfg.duration]
    keep = rng.random(len(cand)) < np.array(
        [rate_fn(float(t)) for t in cand]) / rate_max
    arrivals = cand[keep]
    l_in, l_out = sample_lengths(cfg, len(arrivals), rng)
    return [Request(l_in=int(a), l_pred=0, l_real=int(b), arrival=float(t))
            for a, b, t in zip(l_in, l_out, arrivals)]


def burst_trace(cfg: WorkloadConfig, burst_rate: float,
                burst_start: float, burst_duration: float) -> List[Request]:
    """Base-rate stream with a rectangular rate spike (flash crowd): the
    demand change the Eq. 7 autoscaler's change-point detector must catch."""
    base = cfg.mean_rate

    def rate_fn(t: float) -> float:
        return burst_rate if burst_start <= t < burst_start + burst_duration \
            else base

    return nonhomogeneous_trace(cfg, rate_fn, max(base, burst_rate))


def diurnal_rate_fn(cfg: WorkloadConfig, amplitude: float = 0.5,
                    period: Optional[float] = None,
                    phase: float = 0.0) -> Callable[[float], float]:
    """Ground-truth diurnal rate curve rate(t) = mean·(1 + A·sin(2πt/period)),
    exposed separately so forecast evaluations can compare predictions
    against the true intensity (period defaults to the trace duration)."""
    period = period or cfg.duration
    a = min(max(amplitude, 0.0), 1.0)

    def rate_fn(t: float) -> float:
        return cfg.mean_rate * (1.0 + a * np.sin(2 * np.pi * t / period
                                                 + phase))

    return rate_fn


def diurnal_trace(cfg: WorkloadConfig, amplitude: float = 0.5,
                  period: Optional[float] = None,
                  phase: float = 0.0) -> List[Request]:
    """Sinusoidal day/night demand: rate(t) = mean·(1 + A·sin(2πt/period)).
    period defaults to the trace duration (one full cycle)."""
    a = min(max(amplitude, 0.0), 1.0)
    rate_fn = diurnal_rate_fn(cfg, amplitude, period, phase)
    return nonhomogeneous_trace(cfg, rate_fn, cfg.mean_rate * (1.0 + a))


def drifting_diurnal_rate_fn(cfg: WorkloadConfig, amplitude: float = 0.5,
                             period: Optional[float] = None,
                             drift: float = 0.5,
                             phase: float = 0.0) -> Callable[[float], float]:
    """Diurnal rate curve whose seasonality *drifts*: the instantaneous
    period stretches linearly from ``period`` at t=0 to
    ``period * (1 + drift)`` at t=duration, so the accumulated phase is
    ``2π ∫ dt'/P(t')`` rather than ``2π t/period``. A seasonal-naive
    forecaster keyed to the nominal period accumulates phase error cycle
    after cycle — by mid-trace it provisions for yesterday's peak at
    today's trough — which is exactly the open-loop miscalibration regime
    SLO-feedback scaling exists for."""
    period = period or cfg.duration
    a = min(max(amplitude, 0.0), 1.0)
    d = max(drift, 0.0)

    def cycles(t: float) -> float:
        if d <= 1e-12:
            return t / period
        # ∫0^t dt' / (period * (1 + d*t'/duration))
        return cfg.duration / (period * d) * np.log1p(d * t / cfg.duration)

    def rate_fn(t: float) -> float:
        return cfg.mean_rate * (1.0 + a * np.sin(2 * np.pi * cycles(t)
                                                 + phase))

    return rate_fn


def drifting_diurnal_trace(cfg: WorkloadConfig, amplitude: float = 0.5,
                           period: Optional[float] = None,
                           drift: float = 0.5,
                           phase: float = 0.0) -> List[Request]:
    """Drifted-seasonality demand (see :func:`drifting_diurnal_rate_fn`):
    the trace a forecast policy trained on the nominal ``period``
    mis-serves — the benchmark workload for ``FeedbackScale``."""
    a = min(max(amplitude, 0.0), 1.0)
    rate_fn = drifting_diurnal_rate_fn(cfg, amplitude, period, drift, phase)
    return nonhomogeneous_trace(cfg, rate_fn, cfg.mean_rate * (1.0 + a))


# ---- multi-turn sessions -----------------------------------------------------

@dataclasses.dataclass
class SessionSpec:
    """Multi-turn chat workload: sessions arrive Poisson at ``mean_rate``;
    each runs a geometric number of turns (mean ``mean_turns``, capped at
    ``max_turns``). Turn 0 draws a fresh lognormal prompt; every later turn
    re-submits the previous turn's full context (prompt + reply — the
    cacheable prefix, tagged on the request as ``prefix_len``) plus a
    lognormal ``growth`` of new user tokens. Turn k+1 arrives at
    ``arrival_k + service_proxy * (l_in_k + l_out_k) + think_k`` — a
    finish-independent causal bound (the proxy stands in for service time,
    so a turn can arrive while its predecessor is still queued on a slow
    cluster, but never before the user could plausibly have read the
    previous reply). Deterministic per ``seed``."""
    mean_rate: float = 0.5              # session starts / second (Poisson)
    duration: float = 60.0              # session-start horizon, seconds
    mean_turns: float = 4.0             # geometric mean turn count (>= 1)
    max_turns: int = 12
    in_mu: float = 4.2                  # ln-space first-turn prompt
    in_sigma: float = 1.0
    growth_mu: float = 3.4              # ln-space per-turn new user tokens
    growth_sigma: float = 0.8
    out_mu: float = 5.1                 # ln-space per-turn reply length
    out_sigma: float = 0.9
    think_mu: float = 1.8               # ln-space think time, seconds
    think_sigma: float = 0.8
    service_proxy: float = 0.02         # causal-bound proxy, seconds/token
    max_context: int = 4096
    seed: int = 0


def check_session_envelope(spec: SessionSpec) -> SessionSpec:
    """Validate every ``SessionSpec`` knob (the generator's envelope fence;
    simlint SIM006 requires each field to be validator-inspected)."""
    if not spec.mean_rate > 0:
        raise ValueError(f"mean_rate must be > 0 (got {spec.mean_rate})")
    if not spec.duration > 0:
        raise ValueError(f"duration must be > 0 (got {spec.duration})")
    if not spec.mean_turns >= 1.0:
        raise ValueError(f"mean_turns must be >= 1 (got {spec.mean_turns})")
    if int(spec.max_turns) < 1:
        raise ValueError(f"max_turns must be >= 1 (got {spec.max_turns})")
    dists = {"in_mu": spec.in_mu, "in_sigma": spec.in_sigma,
             "growth_mu": spec.growth_mu, "growth_sigma": spec.growth_sigma,
             "out_mu": spec.out_mu, "out_sigma": spec.out_sigma,
             "think_mu": spec.think_mu, "think_sigma": spec.think_sigma}
    for name, v in dists.items():
        if not np.isfinite(v):
            raise ValueError(f"{name} must be finite (got {v})")
        if name.endswith("sigma") and v < 0:
            raise ValueError(f"{name} must be >= 0 (got {v})")
    if not spec.service_proxy >= 0:
        raise ValueError("service_proxy must be >= 0 "
                         f"(got {spec.service_proxy})")
    if int(spec.max_context) < 8:
        raise ValueError(f"max_context must be >= 8 (got {spec.max_context})")
    if int(spec.seed) < 0:
        raise ValueError(f"seed must be >= 0 (got {spec.seed})")
    return spec


def session_trace(spec: SessionSpec) -> List[Request]:
    """Materialize a :class:`SessionSpec` into an arrival-ordered request
    list. Per-turn invariants (property-tested): ``prefix_len`` is monotone
    non-decreasing within a session and equals the previous turn's full
    context (clipped at the context budget); arrivals within a session are
    strictly causal under the think-time bound; ``l_in >= prefix_len`` and
    ``l_in + l_real <= max_context``."""
    check_session_envelope(spec)
    rng = np.random.default_rng(spec.seed)
    cap_in = spec.max_context // 2      # same per-side budget sample_lengths
    cap_out = spec.max_context // 2     # enforces for single-shot traces
    reqs: List[Request] = []
    sid = 0
    t0 = float(rng.exponential(1.0 / spec.mean_rate))
    while t0 < spec.duration:
        n_turns = min(int(rng.geometric(1.0 / spec.mean_turns)),
                      int(spec.max_turns))
        t = t0
        prefix = 0
        l_in = int(np.clip(int(np.exp(spec.in_mu + spec.in_sigma
                                      * rng.standard_normal())), 4, cap_in))
        for k in range(n_turns):
            l_out = int(np.clip(int(np.exp(spec.out_mu + spec.out_sigma
                                           * rng.standard_normal())),
                                4, cap_out))
            reqs.append(Request(l_in=l_in, l_pred=0, l_real=l_out,
                                arrival=float(t), session_id=sid, turn=k,
                                prefix_len=prefix))
            think = float(np.exp(spec.think_mu + spec.think_sigma
                                 * rng.standard_normal()))
            t = t + spec.service_proxy * (l_in + l_out) + think
            # next turn re-submits the whole conversation so far plus new
            # user tokens; the clip keeps l_in within the context budget
            # (prefix stays monotone: min is over a non-decreasing pair)
            prefix = min(l_in + l_out, cap_in)
            growth = int(np.clip(int(np.exp(
                spec.growth_mu + spec.growth_sigma
                * rng.standard_normal())), 1, cap_in))
            l_in = min(prefix + growth, cap_in)
        sid += 1
        t0 += float(rng.exponential(1.0 / spec.mean_rate))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


# ---- spot-market preemption events -------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreemptionEvent:
    """One market-level spot reclaim: at time ``t`` the provider takes back
    ``frac`` of the *current* spot pool (at least one worker if any are up).
    A fractional reclaim models the correlated nature of real spot markets —
    a capacity crunch reclaims a slice of the pool at once, not independent
    single instances."""
    t: float
    frac: float = 0.25


def preemption_trace(duration: float, event_rate: float,
                     frac: float = 0.25, frac_jitter: float = 0.0,
                     seed: int = 0) -> List[PreemptionEvent]:
    """Poisson stream of market reclaim events over ``[0, duration)``.

    Events arrive at ``event_rate`` per second; each reclaims ``frac`` of the
    spot pool alive at that instant (± uniform ``frac_jitter``, clipped to
    (0, 1]). The effective per-worker hazard — what
    ``core.scaling.SpotMixConfig`` should be fed — is approximately
    ``event_rate * frac``. A pre-generated trace (rather than per-worker
    lifetime draws inside the simulator) keeps preemptions replayable and
    independent of how many workers the policy happens to buy."""
    rng = np.random.default_rng(seed)
    events: List[PreemptionEvent] = []
    t = float(rng.exponential(1.0 / max(event_rate, 1e-12)))
    while t < duration:
        f = frac
        if frac_jitter > 0:
            f += float(rng.uniform(-frac_jitter, frac_jitter))
        f = float(np.clip(f, 1e-6, 1.0))
        events.append(PreemptionEvent(t=t, frac=f))
        t += float(rng.exponential(1.0 / max(event_rate, 1e-12)))
    return events
