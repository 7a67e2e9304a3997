"""Service-level objectives (paper §2.2).

TTFT  — time-to-first-token deadline for the prefill stage (constant per
        deployment; the paper sets it near the full-context prefill latency).
ATGT  — average token-generation time: decode_time / (l_out - 1) must stay
        below the target (the paper's alternative to over-strict TBT).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class SLO:
    ttft: float           # seconds
    atgt: float           # seconds per generated token
    attain_target: float = 1.0   # fraction of requests that must meet both

    def scaled(self, f: float) -> "SLO":
        return SLO(self.ttft * f, self.atgt * f, self.attain_target)


def slo_attainment(finished: Iterable, total: int, slo: "SLO") -> float:
    """Canonical SLO attainment: requests meeting BOTH deadlines over all
    requests offered (ok / total).  Unfinished requests count as misses.

    Every simulator result (colocated, disaggregated, autoscaled) must report
    this one definition, so cost comparisons across serving topologies can
    never drift apart on the metric itself."""
    ok = sum(1 for r in finished if r.slo_ok(slo))
    return ok / max(total, 1)


def slo_metric_ok(r, slo: "SLO", metric: str = "both") -> bool:
    """Per-request SLO verdict restricted to one dimension.

    ``ttft`` judges the prefill hop alone (what a disaggregated prefill
    side controls), ``atgt`` the decode stream alone (the decode side's
    job), ``both`` is the canonical :meth:`Request.slo_ok`. A dimension the
    request never exercised (no first token / single-token output) passes,
    matching ``slo_ok``'s convention."""
    if metric == "both":
        return r.slo_ok(slo)
    if metric == "ttft":
        v, budget = r.ttft(), slo.ttft
    elif metric == "atgt":
        v, budget = r.atgt(), slo.atgt
    else:
        raise ValueError(f"unknown SLO metric {metric!r}")
    return v is None or v <= budget


def windowed_attainment(finished: Iterable, slo: "SLO", t_now: float,
                        window: float, metric: str = "both",
                        ttft_pending: Iterable = ()) -> tuple:
    """Windowed observed attainment for the SLO-feedback controllers:
    (ok, total) over requests finished in ``[t_now - window, t_now]``
    judged by ``metric``, plus assured misses among ``ttft_pending`` —
    requests still waiting whose TTFT budget already expired (counted
    whenever the metric watches TTFT). Those keep the feedback signal
    alive in congestion collapse, when nothing finishes at all. One
    definition shared by every topology, so the per-side controllers of a
    disaggregated cluster and the colocated loop can never drift apart on
    the signal itself."""
    t0 = t_now - window
    ok = total = 0
    for r in finished:
        if r.t_finish is not None and r.t_finish >= t0:
            total += 1
            if slo_metric_ok(r, slo, metric):
                ok += 1
    if metric != "atgt":
        for r in ttft_pending:
            if r.t_first_token is None and t_now - r.arrival > slo.ttft:
                total += 1
    return ok, total


# The paper's Table 2 (A100 testbed), in seconds.
PAPER_SLOS = {
    "llama2-70b": SLO(ttft=1.6, atgt=0.075),
    "llama2-13b": SLO(ttft=0.6, atgt=0.030),
    "llama2-7b": SLO(ttft=0.4, atgt=0.015),
}
