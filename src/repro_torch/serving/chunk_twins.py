"""Small pooled scenarios that reach every branch of the chunked compiled
core (``kernels/fastsim/csrc/chunk.cu``): live KV with preemption churn and
eviction ties, policy-scaled fleets, po2, a spot market with notice, the
KV-crush chaos cell, two tenants, a ``gamma`` whose weighted-context sums
round differently in another order, and a best-fit walk that constraint
(e) turns away from lane after lane.

``chip_smoke.py`` and ``tests/test_torch_cuda_fastsim.py`` run each on the
CPU while ``record_chunks`` keeps every chunk's operands, then replay them
through the kernel on the card against the plain version's outputs.
``order_edge_chunk`` is one hand-made chunk at the edge of constraint (c),
where only the numpy core's summation order admits the queued request."""
import dataclasses
import math
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.perf_model import (DecodeModel, KVModel, PerfModel,
                                         PrefillModel)
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO
from repro_torch.core.worker_config import WorkerSpec, spot_variant
from repro_torch.kernels.fastsim.ops import (BIG, F_LANES, I_LANES,
                                             SCALARS, chunk_layout,
                                             pack_state, unpack_state)
from repro_torch.serving import api, fastsim_jax
from repro_torch.serving import workload as wl
from repro_torch.serving.tenants import materialize_tenants


def kv_spec(kind: str) -> WorkerSpec:
    """A two-accelerator worker with live KV: ``tight`` (6,000 tokens) or
    ``crush`` (2,500: overflow mid-decode, constant churn)."""
    h, j, cap = {"tight": (1.0, 16.0, 6000.0),
                 "crush": (1.0, 8.0, 2500.0)}[kind]
    perf = PerfModel(kv=KVModel(h=h, j=j),
                     prefill=PrefillModel(k1=2.2e-5, c1=8e-3),
                     decode=DecodeModel(k2=6e-6, c2=3.5e-4, c3=9e-3))
    return WorkerSpec(perf=perf, kv_capacity=cap, max_batch=24,
                      n_accelerators=2, name=f"eq-{kind}")


def trace(seed: int, rate: float, duration: float) -> List[Request]:
    return wl.generate_trace(wl.WorkloadConfig(
        mean_rate=rate, duration=duration, seed=seed, tail_frac=0.3,
        in_mu=4.6, out_mu=4.4, out_sigma=1.0))


def scenario(tr, scaling=None, *, policy="aladdin", spec=None, n=2,
             market=None, tenants=None, gamma=0.5):
    return api.Scenario(
        workload=tr, fleet=api.FleetSpec([api.PoolSpec(
            spec or kv_spec("tight"), n)]),
        slo=SLO(2.0, 0.2), tenants=tenants,
        topology=api.Colocated(policy=policy, gamma=gamma),
        scaling=scaling or api.FixedScale(), market=market, seed=0,
        engine="jax")


def bursts() -> List[Request]:
    """Requests that arrive eight at one instant: KV evictions among equal
    arrivals go to the earliest joiner."""
    return [Request(l_in=100 + 37 * k % 300, l_pred=0,
                    l_real=150 + 53 * k % 450, arrival=0.5 + 2.5 * (k // 8))
            for k in range(24)]


def two_tenants():
    """An interactive and a batch tenant: (tenants, merged trace)."""
    chat = api.TenantSpec(
        name="chat",
        workload=lambda: wl.generate_trace(wl.WorkloadConfig(
            mean_rate=4.0, duration=20.0, seed=17, tail_frac=0.2,
            in_mu=4.6, out_mu=4.2, out_sigma=1.0)),
        slo=SLO(ttft=0.6, atgt=0.060), priority=1, tier="interactive")
    ev = api.TenantSpec(
        name="eval",
        workload=lambda: wl.generate_trace(wl.WorkloadConfig(
            mean_rate=4.0, duration=20.0, seed=23, tail_frac=0.3,
            in_mu=5.0, out_mu=4.8, out_sigma=1.1)),
        slo=SLO(ttft=5.0, atgt=0.200), priority=0, tier="batch")
    return [chat, ev], materialize_tenants([chat, ev])


def _spot(notice):
    sspec = spot_variant(kv_spec("tight"), price=0.35,
                         preempt_hazard=1.0 / 60.0)
    events = wl.preemption_trace(30.0, event_rate=1.0 / 8.0, frac=0.5,
                                 seed=13)
    return scenario(trace(5, 3.0, 30.0), n=3, spec=sspec,
                    market=api.SpotMarket(sspec, events, notice_s=notice))


def _chaos():
    # a KV-crushed spot fleet preempts rows mid-decode on the beats that
    # Reactive scale-downs drain lanes and market events kill them
    cspec = spot_variant(kv_spec("crush"), price=0.35,
                         preempt_hazard=1.0 / 60.0)
    events = wl.preemption_trace(30.0, event_rate=1.0 / 6.0, frac=0.4,
                                 seed=2)
    return scenario(trace(9, 5.0, 30.0), api.Reactive(
        interval=4.0, min_workers=1, max_workers=5), n=3, spec=cspec,
        market=api.SpotMarket(cspec, events))


def _tenants():
    tenants, merged = two_tenants()
    return scenario(merged, spec=kv_spec("crush"), tenants=tenants)


def e_walk_trace() -> List[Request]:
    """For ``crush-e-walk``: first, at 0, a request whose context at its
    end (l_in + l_real) exceeds 0.9 of a crush lane's KV, so every lane
    passes constraints (a)-(d) for it and fails (e), and it never finds a
    lane; then bursts of nine identical requests that arrive at one instant
    (four fit a lane under (e): the best-fit walk rejects the fullest lanes
    in turn, and lanes of equal load tie by rank), each with a one-token
    request behind a prompt whose prefill outlasts a 50 ms beat, so it is a
    member with nothing left to decode (rem 0) at the next placement
    pass."""
    reqs = [Request(l_in=100, l_pred=0, l_real=2300, arrival=0.0)]
    for b in range(12):
        t = 0.5 + 1.5 * b
        reqs += [Request(l_in=200, l_pred=0, l_real=300, arrival=t)
                 for _ in range(9)]
        reqs.append(Request(l_in=2000, l_pred=0, l_real=1, arrival=t))
    return reqs


def _e_walk():
    sc = scenario(e_walk_trace(), spec=kv_spec("crush"), n=6)
    return dataclasses.replace(sc, topology=dataclasses.replace(
        sc.topology, heartbeat=0.05))


TWINS: Dict[str, Callable[[], api.Scenario]] = {
    "tight-aladdin": lambda: scenario(trace(11, 3.0, 20.0)),
    "crush-jsq": lambda: scenario(trace(11, 3.0, 20.0), policy="jsq",
                                  spec=kv_spec("crush")),
    "crush-aladdin-gamma-0.3": lambda: scenario(
        trace(11, 3.0, 20.0), spec=kv_spec("crush"), gamma=0.3),
    "reactive": lambda: scenario(trace(21, 3.0, 30.0), api.Reactive(
        interval=5.0, min_workers=2), n=3),
    "feedback": lambda: scenario(trace(21, 3.0, 30.0), api.FeedbackScale(
        base=api.Forecast(period=30.0, min_workers=2), min_gain=0.85,
        max_gain=1.3, boost=1.2, decay=0.02, window=20.0), n=3),
    "po2-reactive": lambda: scenario(trace(21, 3.0, 30.0), api.Reactive(
        interval=5.0, min_workers=2), policy="po2", n=3),
    "spot-notice": lambda: _spot(4.0),
    "chaos": _chaos,
    "eviction-ties": lambda: scenario(bursts(), spec=kv_spec("crush"), n=1),
    "tenants-crush-aladdin": _tenants,
    "crush-e-walk": _e_walk,
}


def record_chunks(fn) -> List[Tuple]:
    """Run ``fn()`` while keeping every chunk call's operands (cloned),
    statics, outputs and host seconds."""
    calls = []
    inner = fastsim_jax.chunk

    def record(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        calls.append(([a.clone() for a in args], kw, out,
                      time.perf_counter() - t0))
        return out

    fastsim_jax.chunk = record
    try:
        fn()
    finally:
        fastsim_jax.chunk = inner
    return calls


def twin_chunks(name: str) -> List[Tuple]:
    """``TWINS[name]`` on the plain version, every chunk recorded."""
    sc = TWINS[name]()
    sc = dataclasses.replace(sc, workload=wl.clone_trace(sc.workload))
    return record_chunks(lambda: fastsim_jax.run_colocated_jax(
        sc, device="cpu"))


def order_edge_chunk(gamma: float = 0.3, rows: int = 6, seed: int = 0):
    """One lane, ``rows`` ongoing rows whose slots are not in join order,
    and one queued request, with coefficients that make constraint (c)'s
    test ``wctx + v <= theta * budget`` an exact equality when the weighted
    context is summed in join order (the numpy core's) and false when it is
    summed in slot order. Every other constraint holds with room. Returns
    the chunk's operands and statics ``(args, kw)``; the request is placed
    (the queue empties) if and only if the sum runs in join order."""
    rng = np.random.default_rng(seed)
    for _ in range(10_000):
        li = [int(x) for x in rng.integers(50, 500, rows + 1)]
        lr = [int(x) for x in rng.integers(1_000, 5_000, rows + 1)]
        join = [int(x) for x in rng.permutation(rows)]   # slot -> join seq
        vals = [li[s] + gamma * lr[s] for s in range(rows)]
        by_slot = by_join = 0.0
        for s in range(rows):
            by_slot += vals[s]
        for s in sorted(range(rows), key=join.__getitem__):
            by_join += vals[s]
        v = li[rows] + gamma * lr[rows]
        if by_slot + v > by_join + v:
            break
    else:
        raise RuntimeError("order_edge_chunk: no edge case found")
    W, B, Q, n = 1, rows + 2, 4, rows + 1
    nf, ni, _ = chunk_layout(W, B, Q)
    st = unpack_state(np.zeros(nf), np.zeros(ni, np.int64), W, B, Q)
    pad = [0, 0]
    st.update(theta=1.0, K2=1.0, M=1.0, MAXBN=1.0, CMAXN=1.0,
              rtf1=[0.0] * rows + [math.nan] * 2, rtpe=math.nan,
              rtfn=math.nan, K=1, idx=rows, seqc=rows, jc=rows, MAXB=100,
              mode=2, empty_at=BIG, sst=[2] * rows + pad,
              rid=list(range(rows)) + pad, rli=li[:rows] + pad,
              rlr=lr[:rows] + pad, rlo=[5] * rows + pad,
              rnsq=list(range(rows)) + pad, rjsq=join + pad)
    f, i = pack_state({k: np.broadcast_to(v, np.shape(st[k]))
                       for k, v in st.items()}, W, B, Q)
    atgt = by_join + v          # theta * budget with K2 1, C2 = C3 = 0
    inf = np.full(n, math.inf)
    args = (torch.from_numpy(f)[None], torch.from_numpy(i)[None],
            torch.zeros(n, dtype=torch.float64),
            torch.tensor(li, dtype=torch.int64),
            torch.tensor(lr, dtype=torch.int64),
            torch.arange(n, dtype=torch.int64),
            torch.tensor(inf), torch.tensor(inf),
            torch.zeros((1, n), dtype=torch.int64),
            torch.tensor(np.stack([np.zeros(n), np.full(n, math.nan),
                                   np.full(n, math.nan)]))[None])
    kw = dict(W=W, B=B, Q=Q, hb=0.25, gamma=gamma, ttft=2.0, atgt=atgt,
              policy="aladdin")
    return args, kw


def widen(args, kw, W2: int, B2: int):
    """A recorded chunk's operands with each candidate's state moved into
    ``W2`` lanes of ``B2`` slots (at least the chunk's own): the added lanes
    off (mode 0), the added slots free. The chunk then runs the same
    decisions, from a state whose member lists take more memory. Returns
    ``(args, kw)``."""
    W, B, Q = kw["W"], kw["B"], kw["Q"]
    pads = {"mode": 0, "rank": BIG, "empty_at": BIG, "MAXB": 1,
            "rtf1": math.nan, "rtpe": math.nan, "rtfn": math.nan}
    fo, io = [], []
    for c in range(args[0].shape[0]):
        st = unpack_state(args[0][c].numpy(), args[1][c].numpy(), W, B, Q)
        new = {}
        for name, v in st.items():
            if name in SCALARS or name == "q":
                new[name] = v
            elif name in F_LANES or name in I_LANES:
                new[name] = np.concatenate(
                    [v, np.full(W2 - W, pads.get(name, 0), v.dtype)])
            else:
                rows = np.full((W2, B2), pads.get(name, 0), v.dtype)
                rows[:W, :B] = v.reshape(W, B)
                new[name] = rows
        f, i = pack_state(new, W2, B2, Q)
        fo.append(f)
        io.append(i)
    return ((torch.from_numpy(np.stack(fo)), torch.from_numpy(np.stack(io)))
            + tuple(args[2:]), dict(kw, W=W2, B=B2))
