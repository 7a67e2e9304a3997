"""Worker-count autoscaling (paper §5.2) + change-point detection.

Above an arrival-rate floor R the required worker count is linear in the
arrival rate:  N_w = ceil(k5 * r_a + c5)  (Eq. 7), with (k5, c5) learned from
(rate, workers-needed) history. Below R the length-distribution sample is too
small (SEM = sigma/sqrt(n)) to trust the linear fit, so the scaler falls back
to the most recent empirical requirement plus head-room.

Demand change points are detected on the arrival-rate stream with a simple
two-window mean-shift test; each cluster heartbeat with a change point (or a
drifted prediction) triggers reconfiguration.

``split_spot_mix`` extends the worker-count decision with a price class: given
a total capacity target, the spot discount and the preemption hazard, it
returns the cheapest (on-demand, spot) split whose *expected surviving*
capacity still covers the target."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

# History window: keep at most this many observations; halve when exceeded.
HISTORY_MAX = 4096


@dataclasses.dataclass
class AutoscalerConfig:
    heartbeat: float = 10.0            # seconds between scaling decisions
    min_workers: int = 1
    max_workers: int = 4096
    sem_target: float = 0.1            # SEM/sigma floor defining R
    headroom: float = 1.10             # spare capacity when below R
    change_window: int = 8             # heartbeats per mean-shift window
    change_z: float = 3.0              # z-score to declare a change point


class Autoscaler:
    def __init__(self, cfg: AutoscalerConfig = AutoscalerConfig()):
        self.cfg = cfg
        self.history: List[Tuple[float, int]] = []   # (rate, workers needed)
        self.rates: List[float] = []
        self.k5: Optional[float] = None
        self.c5: Optional[float] = None
        # running Σx, Σy, Σxy, Σx² for an O(1) two-parameter least squares
        # per observation (rebuilt only when the history window is trimmed)
        self._sums = [0.0, 0.0, 0.0, 0.0]

    # ---- Eq. 7 fit -----------------------------------------------------------
    def observe(self, rate: float, workers_needed: int) -> None:
        self.history.append((rate, workers_needed))
        self.rates.append(rate)
        x, y = float(rate), float(workers_needed)
        s = self._sums
        s[0] += x
        s[1] += y
        s[2] += x * y
        s[3] += x * x
        if len(self.history) > HISTORY_MAX:
            del self.history[:HISTORY_MAX // 2]
            self._sums = [sum(r for r, _ in self.history),
                          sum(float(n) for _, n in self.history),
                          sum(r * n for r, n in self.history),
                          sum(r * r for r, _ in self.history)]
            s = self._sums
        if len(self.rates) > HISTORY_MAX:
            # change_point() only looks at the last 2*change_window entries,
            # so dropping the old half never alters its verdict
            del self.rates[:HISTORY_MAX // 2]
        n = len(self.history)
        if n >= 4:
            det = n * s[3] - s[0] * s[0]
            if abs(det) > 1e-12:
                self.k5 = (n * s[2] - s[0] * s[1]) / det
                self.c5 = (s[1] * s[3] - s[0] * s[2]) / det

    def rate_floor(self) -> float:
        """R: smallest rate whose per-heartbeat sample keeps SEM below
        sem_target * sigma.  SEM = sigma/sqrt(n) <= sem_target * sigma needs
        n >= 1/sem_target^2 samples; with n = r * heartbeat the length sigma
        cancels, so the floor depends only on (sem_target, heartbeat)."""
        n_min = 1.0 / (self.cfg.sem_target ** 2)
        return n_min / max(self.cfg.heartbeat, 1e-9)

    def predict_workers(self, rate: float,
                        last_needed: Optional[int] = None) -> int:
        cfg = self.cfg
        if self.k5 is not None and rate > self.rate_floor():
            n = math.ceil(self.k5 * rate + self.c5)
        elif last_needed is not None:
            n = math.ceil(last_needed * cfg.headroom)
        else:
            n = cfg.min_workers
        return int(min(max(n, cfg.min_workers), cfg.max_workers))

    # ---- change-point detection -----------------------------------------------
    def change_point(self) -> bool:
        w = self.cfg.change_window
        if len(self.rates) < 2 * w:
            return False
        a = np.asarray(self.rates[-2 * w:-w], np.float64)
        b = np.asarray(self.rates[-w:], np.float64)
        pooled = math.sqrt((a.var() + b.var()) / 2 + 1e-12)
        z = abs(b.mean() - a.mean()) / (pooled / math.sqrt(w) + 1e-12)
        return z > self.cfg.change_z


# ---- SLO-feedback gain control -----------------------------------------------

@dataclasses.dataclass
class FeedbackConfig:
    """Closed-loop correction on *observed* SLO attainment.

    The open-loop policies (reactive, forecast) size the fleet from demand
    estimates alone; when the rate model is miscalibrated (drifted
    seasonality, burst regime change) they either violate SLOs or
    over-provision. The feedback controller multiplies the open-loop target
    by a gain driven by the windowed attainment the cluster actually
    delivered:

      * attainment below ``slo_target - deadband`` → multiply the gain by
        ``boost`` (fast multiplicative attack on misses), at most once per
        ``attack_cooldown`` seconds (default: the window length) — the
        misses that triggered a boost stay *in* the window for a while, and
        re-boosting on the same stale evidence every epoch would race the
        gain to ``max_gain`` before the extra capacity could even boot;
      * attainment at or above ``slo_target + deadband`` → subtract
        ``decay`` (slow additive release while the SLO saturates), down to
        ``min_gain`` — below 1.0 this shaves open-loop over-provisioning;
      * inside the deadband → hold (hysteresis: no oscillation on a flat
        trace).

    ``window`` is the attainment observation window in seconds;
    ``min_samples`` keeps the controller inert until the window holds a
    meaningful sample. An infinite ``deadband`` disables both thresholds,
    making the closed loop bit-for-bit identical to its open-loop base."""
    slo_target: float = 0.99
    deadband: float = 0.005
    boost: float = 1.3
    decay: float = 0.02
    max_gain: float = 3.0
    min_gain: float = 1.0
    window: float = 30.0
    min_samples: int = 8
    attack_cooldown: Optional[float] = None   # None: one boost per window


class AttainmentController:
    """The MIAD gain state machine of :class:`FeedbackConfig` (multiplicative
    increase on SLO misses, additive decrease on saturation).

    Pure arithmetic over (ok, total) observations — no simulator types — so
    its hysteresis and monotonicity properties are unit-testable in
    isolation (tests/test_feedback.py)."""

    def __init__(self, cfg: Optional[FeedbackConfig] = None):
        self.cfg = cfg if cfg is not None else FeedbackConfig()
        self.gain = 1.0
        self._last_attack = -math.inf

    def observe(self, t: float, ok: int, total: int) -> float:
        """Fold one windowed (ok, total) attainment sample, observed at
        time ``t``, into the gain."""
        cfg = self.cfg
        if total < cfg.min_samples:
            return self.gain
        att = ok / total
        lo = cfg.slo_target - cfg.deadband
        hi = cfg.slo_target + cfg.deadband
        if math.isfinite(hi):
            # a reachable release threshold even when target+deadband > 1
            hi = min(hi, 1.0)
        cooldown = cfg.attack_cooldown if cfg.attack_cooldown is not None \
            else cfg.window
        if att < lo:
            if t - self._last_attack >= cooldown:
                self.gain = min(self.gain * cfg.boost, cfg.max_gain)
                self._last_attack = t
        elif att >= hi:
            self.gain = max(self.gain - cfg.decay, cfg.min_gain)
        return self.gain

    def apply(self, target: int) -> int:
        """Scale an open-loop worker target by the current gain. Gain 1.0
        returns the target untouched — the exact open-loop integer."""
        if self.gain == 1.0:
            return target
        return max(int(math.ceil(target * self.gain)), 0)


# ---- spot / on-demand mix planning -------------------------------------------

@dataclasses.dataclass
class SpotMixConfig:
    """Economics of a preemptible capacity pool next to the on-demand one.

    ``hazard`` is the per-worker per-second reclaim rate; ``horizon`` is the
    exposure window the planner must survive — the time until a replacement
    decision can take effect (scaling epoch + provisioning delay), over which
    a spot worker survives with probability ``exp(-hazard * horizon)``.
    ``discount`` is the spot price as a fraction of on-demand. Spot capacity
    is worth buying only while ``discount / survival < 1`` — i.e. a unit of
    *expected surviving* spot capacity (one worker inflated by 1/survival)
    still bills below one on-demand worker.

    ``max_spot_frac`` caps the capacity share served from spot: reclaims are
    correlated in real markets (capacity crunches take out whole pools), so
    some on-demand base always remains. ``spot_frac`` forces a fixed split
    (tests and what-if sweeps); None lets the economics decide."""
    discount: float = 0.35
    hazard: float = 1.0 / 1800.0
    horizon: float = 15.0
    max_spot_frac: float = 0.7
    spot_frac: Optional[float] = None

    def survival(self) -> float:
        return math.exp(-self.hazard * max(self.horizon, 0.0))


def split_spot_mix(target: int, mix: SpotMixConfig) -> Tuple[int, int]:
    """Cheapest (n_on_demand, n_spot) covering ``target`` expected capacity.

    A share of the target (at most ``max_spot_frac``) is assigned to spot and
    inflated by 1/survival so the *expected* surviving spot workers still
    cover that share at the end of the exposure horizon; the rest stays
    on-demand. When spot is uneconomical (discount / survival >= 1, i.e. the
    attrition premium eats the discount) the split is all on-demand."""
    if target <= 0:
        return 0, 0
    p = mix.survival()
    if p <= 1e-9:
        return target, 0       # even a forced share can't survive the horizon
    if mix.spot_frac is not None:
        share = int(round(target * min(max(mix.spot_frac, 0.0), 1.0)))
    elif mix.discount / p >= 1.0:
        return target, 0
    else:
        share = int(target * mix.max_spot_frac)
    if share <= 0:
        return target, 0
    n_spot = int(math.ceil(share / max(p, 1e-9)))
    if mix.spot_frac is None and \
            (target - share) + n_spot * mix.discount >= target:
        # the ceil() inflation ate the discount at this scale (near the
        # break-even ratio, small targets round the attrition premium up
        # past the saving) — honor the "cheapest split" contract
        return target, 0
    return target - share, n_spot
