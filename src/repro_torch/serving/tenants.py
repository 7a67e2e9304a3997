"""Multi-tenant serving: per-class SLOs over one shared fleet.

Production clusters serve many models and traffic classes on a shared
pool — interactive chat next to batch/eval traffic, LoRA fine-tunes
multiplexed on shared base workers. A :class:`TenantSpec` names one such
traffic class: its own workload, its own TTFT/ATGT SLO, an admission
priority, and optionally a LoRA adapter. ``Scenario(tenants=[...])``
accepts a list of them in place of the scalar ``workload``/``slo`` pair;
the merged trace tags every :class:`~repro.core.request.Request` with
its tenant, and the queue discipline becomes priority-then-EDF
(earliest deadline first by SLO slack) so batch-tier traffic soaks
trough capacity without breaking interactive TTFT.

Placement keeps the scalar engine's bit-for-bit-pinned kernels by
splitting SLO roles:

* the *planning SLO* (:func:`planning_slo` — the strictest TTFT/ATGT
  across tenants) parameterizes worker-level scoring (capacity_norm);
* the per-request constraint budgets (constraints (b)/(c)/(d) of
  §4.2) read each request's own tenant budgets, stamped on the request
  at merge time (``slo_ttft``/``slo_atgt``), with ``inf`` falling back
  to the planning SLO so untagged traces are arithmetically untouched;
* *attainment* is judged per tenant against each tenant's own SLO at
  reporting time (:func:`tenant_rows`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.slo import SLO
from repro_torch.serving.workload import mixture_trace

__all__ = ["TenantSpec", "planning_slo", "materialize_tenants",
           "tenant_attainment", "tenant_rows"]


@dataclasses.dataclass
class TenantSpec:
    """One traffic class sharing the fleet.

    ``workload`` is a materialized trace or a zero-arg factory (the same
    contract as ``Scenario.workload``); ``priority`` breaks admission
    ties (higher places first; EDF deadline ordering within a priority
    level); ``model`` is a descriptive label for reporting; ``lora``
    names an adapter multiplexed on shared base workers (reference
    engine only — workers need ``lora_slots``); ``tier`` is
    ``"interactive"`` or ``"batch"``; ``attain_target`` optionally
    overrides the fleet-wide attainment floor ``optimize()`` enforces
    for this tenant."""
    name: str
    workload: object
    slo: SLO
    priority: int = 0
    model: str = ""
    lora: Optional[str] = None
    tier: str = "interactive"
    attain_target: Optional[float] = None

    def materialize(self) -> List[Request]:
        w = self.workload
        return list(w() if callable(w) else w)


def planning_slo(tenants: Sequence[TenantSpec]) -> SLO:
    """The fleet-planning SLO: strictest TTFT and ATGT across tenants.

    Worker-level scoring (capacity_norm's context normalization) uses one
    SLO per worker; taking the strictest keeps the scalar placement
    kernels intact while per-request budgets relax constraints (b)-(d)
    for looser tenants. For a single tenant this is exactly its own SLO,
    which is what makes ``Scenario(tenants=[one])`` reproduce the scalar
    path bit-for-bit."""
    if not tenants:
        raise ValueError("tenants must be non-empty")
    return SLO(ttft=min(t.slo.ttft for t in tenants),
               atgt=min(t.slo.atgt for t in tenants))


def materialize_tenants(tenants: Sequence[TenantSpec]) -> List[Request]:
    """Materialize every tenant's workload, merge the streams with
    :func:`repro.serving.workload.mixture_trace` (stable arrival-order
    tie-break), and stamp each request with its tenant's priority and
    SLO budgets."""
    merged = mixture_trace([t.materialize() for t in tenants])
    for r in merged:
        spec = tenants[r.tenant]
        r.priority = int(spec.priority)
        r.slo_ttft = float(spec.slo.ttft)
        r.slo_atgt = float(spec.slo.atgt)
    return merged


def _request_ok(r: Request) -> bool:
    """SLO judgement against the request's own tenant budgets (unfinished
    requests count as misses, like ``slo_attainment``)."""
    if r.t_finish is None:
        return False
    t1 = r.ttft()
    if t1 is not None and not (t1 <= r.slo_ttft):
        return False
    t2 = r.atgt()
    if t2 is not None and not (t2 <= r.slo_atgt):
        return False
    return True


def tenant_attainment(trace: Sequence[Request]) -> float:
    """Fleet attainment with every request judged against its own
    tenant's SLO (the multi-tenant headline number)."""
    if not trace:
        return 1.0
    return sum(1 for r in trace if _request_ok(r)) / len(trace)


def tenant_rows(trace: Sequence[Request], tenants: Sequence[TenantSpec],
                gpu_cost: float) -> List[Dict]:
    """Per-tenant report rows: attainment vs the tenant's own SLO, p99
    TTFT/ATGT over its finished requests, mean queue delay (time from
    arrival to first token), and the tenant's gpu-cost share (total
    fleet cost split by processed-token share: ``l_in + l_out``)."""
    tokens = [0.0] * len(tenants)
    for r in trace:
        tokens[r.tenant] += r.l_in + r.l_out
    tok_total = sum(tokens) or 1.0
    rows: List[Dict] = []
    for k, spec in enumerate(tenants):
        reqs = [r for r in trace if r.tenant == k]
        fin = [r for r in reqs if r.t_finish is not None]
        ttfts = [r.ttft() for r in fin if r.t_first_token is not None]
        atgts = [a for a in (r.atgt() for r in fin) if a is not None]
        ok = sum(1 for r in reqs if _request_ok(r))
        share = tokens[k] / tok_total
        rows.append({
            "tenant": spec.name,
            "tier": spec.tier,
            "priority": int(spec.priority),
            "model": spec.model,
            "lora": spec.lora,
            "attainment": ok / max(len(reqs), 1),
            "p99_ttft": float(np.percentile(ttfts, 99)) if ttfts
            else math.nan,
            "p99_atgt": float(np.percentile(atgts, 99)) if atgts
            else math.nan,
            "mean_queue_delay": float(np.mean(ttfts)) if ttfts
            else math.nan,
            "finished": len(fin),
            "total": len(reqs),
            "gpu_cost_share": share,
            "gpu_cost": share * gpu_cost,
        })
    return rows
