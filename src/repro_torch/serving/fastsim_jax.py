"""Compiled colocated simulation core (the ``engine="jax"`` path of the
Scenario API), on the CUDA card.

This module imports no JAX. It is the port's counterpart of the
reference's jit core (``repro.serving.fastsim_jax``) and keeps its module
path and public names, so that the copied ``api.py`` and ``fastsim.py``
reach it unchanged: in the port, ``engine="jax"`` means "the compiled
core, on the card".

The port has the reference's *whole-trace* core: inert KV, fixed
``aladdin``/``jsq`` fleets, no market (``_legacy_ok``). One launch of the
hand-written kernel behind :func:`repro_torch.kernels.fastsim.whole_trace`
runs the whole heartbeat loop of a trace, one CTA per candidate fleet
size, so :func:`run_candidate_batch` evaluates a whole bracket of
``optimize``'s search in one launch, as the reference's ``vmap`` does. The
reference's *chunked* core (live KV, po2, policy-scaled fleets, spot
markets) is not ported yet: such scenarios raise ``NotImplementedError``
naming ROADMAP "A12 part 2 (chunked core)"; ``engine="reference"`` and
``engine="vectorized"`` run them.

Every entry point takes ``device``: ``None`` is the CUDA card, and raises
on a machine without one; ``device="cpu"`` runs the kernel's plain
version. Results agree with the numpy core (``serving/fastsim.py``), which
is bit for bit equal to the reference engine: the kernel keeps its
operation order and adds no fused multiply-add.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.request import ReqState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fastsim import whole_trace
from repro_torch.serving.fastsim import (DEFAULT_TAIL,
                                         check_colocated_envelope,
                                         check_trace_session_free)

_PART2 = ("ROADMAP A12 part 2 (chunked core): the port's compiled core "
          "covers inert-KV fixed aladdin/jsq fleets without a market; run "
          "this scenario with engine='reference' or engine='vectorized'")


def check_jax_envelope(scenario) -> List:
    """The vectorized-engine envelope, with a positive KV capacity. Of it,
    the port's compiled core runs the part ``_legacy_ok`` admits."""
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
    rank_r, ttft_r, atgt_r, tagged = _tenant_arrays(ordered)
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
    order = sorted(range(len(trace)), key=lambda i: trace[i].arrival)
    ordered = [trace[i] for i in order]
    arrival = np.array([r.arrival for r in ordered])
    l_in = np.array([r.l_in for r in ordered], dtype=np.int64)
    l_real = np.array([r.l_real for r in ordered], dtype=np.int64)
    return ordered, arrival, l_in, l_real


def _tenant_arrays(ordered):
    """Per-request multi-tenant operands for the kernels: the total queue
    rank (priority desc, deadline asc, arrival index — the order a stable
    reference sort converges to; after a requeue an exact-key tie can
    differ, which the tolerance pins absorb) and the RAW per-request SLO
    budgets (``inf`` = untagged; the kernels resolve the fallback to the
    planning SLO in-branch, like the reference). ``tagged`` mirrors the
    reference's trace-level gate (any finite ATGT budget)."""
    n = len(ordered)
    prio = np.array([int(r.priority) for r in ordered], dtype=np.int64)
    dl = np.array([r.deadline for r in ordered])
    rank = np.empty(n, dtype=np.int64)
    rank[np.lexsort((dl, -prio))] = np.arange(n, dtype=np.int64)
    ttft_r = np.array([r.slo_ttft for r in ordered])
    atgt_r = np.array([r.slo_atgt for r in ordered])
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


def run_colocated_jax(scenario, seed: Optional[int] = None,
                      device: DeviceLike = None):
    """Run a colocated ``Scenario`` on the compiled core, mutate the
    trace's ``Request`` objects with the outcome (the same contract as the
    other engines) and return the ``RunReport``, with the executed beat
    count in the side channel ``rep.beats``. ``seed`` reaches only the
    numpy core (an empty trace outside the whole-trace envelope); the
    whole-trace core draws nothing."""
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
        raise NotImplementedError(_PART2)
    l_out, tds, t_first, t_fin, beats = _simulate(
        scenario, specs, ordered, arrival, l_in, l_real, len(specs), dev,
        edf=multi)
    for pos, r in enumerate(ordered):
        r.l_pred = int(l_real[pos])
        r.l_out = int(l_out[pos])
        r.t_decode_spent = float(tds[pos])
        tf = t_first[pos]
        r.t_first_token = None if math.isnan(tf) else float(tf)
        te = t_fin[pos]
        if not math.isnan(te):
            r.t_finish = float(te)
            r.state = ReqState.FINISHED
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
        raise NotImplementedError(_PART2)
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
    """The reference's lockstep batch of policy-knob candidates runs on its
    chunked core, which the port does not have yet."""
    raise NotImplementedError(_PART2)
