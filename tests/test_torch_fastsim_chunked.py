"""The port's chunked compiled core on the CPU: ``engine="jax"`` outside
the whole-trace envelope (live KV, po2, policy-scaled fleets, spot
markets, two tenants), through the chunk kernel's plain version
(``device="cpu"``), against the JAX package's numpy core
(``engine="vectorized"``) and the port's reference engine on the same
traces.

The cells twin the chunked-core cells of
``tests/test_fastsim_equivalence.py``. Against the numpy core every
request's ``(t_first_token, t_finish, l_out, t_decode_spent)`` is held bit
for bit, and so are the beat count, the billed GPU-seconds and the
lifecycle counters; a report's mean may differ in the last ulp (it
averages in finish order, and requests that finish at one instant may be
listed in another order). Two exceptions keep the reference grid's
tolerances (integers exact, per-request floats ``rel=1e-12``, report
floats ``rel=1e-9``): two tenants, whose backlog the compiled cores sort
by a total rank where the numpy core's stable sort may keep a requeued
request behind an exact-key tie; and po2, whose two candidates come from
the port's own counter-based generator, not the numpy core's Generator,
so it is held as deterministic and within 0.15 of the reference's
attainment."""
import dataclasses
import enum
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import api as ref_api  # noqa: E402
from repro_torch.core.placement import kv_peak_arrays  # noqa: E402
from repro_torch.core.perf_model import (DecodeModel, KVModel,  # noqa: E402
                                         PerfModel, PrefillModel)
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.core.worker_config import (WorkerSpec,  # noqa: E402
                                            spot_variant)
from repro_torch.kernels.fastsim import (chunk, chunk_layout,  # noqa: E402
                                         chunk_plain)
from repro_torch.kernels.fastsim.ops import (F_LANES, F_ROWS,  # noqa: E402
                                             I_LANES, I_ROWS, STATS,
                                             unpack_state)
from repro_torch.serving import api, fastsim_jax  # noqa: E402
from repro_torch.serving import chunk_twins  # noqa: E402
from repro_torch.serving.chunk_twins import order_edge_chunk  # noqa: E402
from repro_torch.serving.tenants import materialize_tenants  # noqa: E402
from repro_torch.serving.workload import (WorkloadConfig,  # noqa: E402
                                          clone_trace, generate_trace,
                                          preemption_trace)

SLO_GRID = SLO(ttft=2.0, atgt=0.2)


def _spec(kv: str) -> WorkerSpec:
    if kv == "tight":
        kvm, cap = KVModel(h=1.0, j=16.0), 6000.0
    else:                   # crush: overflow mid-decode, constant churn
        kvm, cap = KVModel(h=1.0, j=8.0), 2500.0
    perf = PerfModel(kv=kvm,
                     prefill=PrefillModel(k1=2.2e-5, c1=8e-3),
                     decode=DecodeModel(k2=6e-6, c2=3.5e-4, c3=9e-3))
    return WorkerSpec(perf=perf, kv_capacity=cap, max_batch=24,
                      n_accelerators=2, name=f"eq-{kv}")


def _grid_trace():
    return generate_trace(WorkloadConfig(
        mean_rate=3.0, duration=20.0, seed=11, tail_frac=0.3,
        in_mu=4.6, out_mu=4.4, out_sigma=1.0))


def _pooled_trace(seed=21, rate=3.0):
    return generate_trace(WorkloadConfig(
        mean_rate=rate, duration=30.0, seed=seed, tail_frac=0.3,
        in_mu=4.6, out_mu=4.4, out_sigma=1.0))


def _scenario(trace, scaling=None, *, policy="aladdin", market=None,
              spec=None, n=2, tenants=None, engine="jax", gamma=0.5):
    return api.Scenario(
        workload=trace,
        fleet=api.FleetSpec([api.PoolSpec(spec or _spec("tight"), n)]),
        slo=SLO_GRID, tenants=tenants,
        topology=api.Colocated(policy=policy, gamma=gamma),
        scaling=scaling if scaling is not None else api.FixedScale(),
        market=market, seed=0, engine=engine)


def _to_ref(x):
    """A port object as the JAX package's twin, field by field (dataclasses
    and enums by module and name; lists, tuples and the rest as they are)."""
    if isinstance(x, enum.Enum):
        mod = type(x).__module__.replace("repro_torch", "repro", 1)
        return getattr(getattr(importlib.import_module(mod),
                               type(x).__name__), x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        mod = type(x).__module__.replace("repro_torch", "repro", 1)
        cls = getattr(importlib.import_module(mod), type(x).__name__)
        return cls(**{f.name: _to_ref(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(_to_ref(v) for v in x)
    return x


def _numpy_core(sc):
    """``sc`` through the JAX package's numpy core; (report, trace)."""
    trace = _to_ref(list(sc.workload))
    ref = dataclasses.replace(_to_ref(dataclasses.replace(sc, workload=[])),
                              workload=trace, engine="vectorized")
    if sc.tenants is not None:      # their workloads are callables
        ref = dataclasses.replace(ref, tenants=[
            ref_api.TenantSpec(**{f.name: getattr(t, f.name)
                                  for f in dataclasses.fields(t)})
            for t in sc.tenants])
    return ref_api.run(ref), trace


def _port_jax(sc):
    trace = clone_trace(sc.workload)
    rep = fastsim_jax.run_colocated_jax(
        dataclasses.replace(sc, workload=trace), device="cpu")
    return rep, trace


def _port_reference(sc):
    trace = clone_trace(sc.workload)
    rep = api.run(dataclasses.replace(sc, workload=trace,
                                      engine="reference"))
    return rep, trace


def _held_requests(want, got, exact: bool) -> None:
    key = lambda r: (r.arrival, r.id)  # noqa: E731
    assert len(want) == len(got)
    for a, b in zip(sorted(want, key=key), sorted(got, key=key)):
        assert a.l_out == b.l_out
        assert a.preempt_count == b.preempt_count
        assert (a.t_finish is None) == (b.t_finish is None)
        assert (a.t_first_token is None) == (b.t_first_token is None)
        if exact:
            assert (a.t_first_token, a.t_finish, a.t_decode_spent,
                    a.t_preempted) == (b.t_first_token, b.t_finish,
                                       b.t_decode_spent, b.t_preempted)
            continue
        for x, y in ((a.t_first_token, b.t_first_token),
                     (a.t_finish, b.t_finish),
                     (a.t_decode_spent, b.t_decode_spent)):
            if x is not None:
                assert y == pytest.approx(x, rel=1e-12)


def _held_rows(want: dict, got: dict, rel: float = 1e-9) -> None:
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], float):
            if math.isnan(want[k]):
                assert math.isnan(got[k]), k
            else:
                assert got[k] == pytest.approx(want[k], rel=rel,
                                               abs=1e-12), k
        else:
            assert want[k] == got[k], k


def _bit_for_bit(sc) -> None:
    """``sc`` on the port's compiled core against the numpy core (bit for
    bit per request; beats, GPU-seconds and lifecycle counters equal) and
    the port's reference engine (bit for bit per request)."""
    jx, jx_t = _port_jax(sc)
    vec, vec_t = _numpy_core(sc)
    ref, ref_t = _port_reference(sc)
    assert vec.finished > 0
    _held_requests(vec_t, jx_t, exact=True)
    _held_requests(ref_t, jx_t, exact=True)
    assert (jx.beats, jx.gpu_seconds, jx.spot_gpu_seconds,
            jx.preempted_workers, jx.drained_ok, jx.requeued,
            jx.peak_workers) == (vec.beats, vec.gpu_seconds,
                                 vec.spot_gpu_seconds, vec.preempted_workers,
                                 vec.drained_ok, vec.requeued,
                                 vec.peak_workers)
    assert jx.epochs == ref.epochs
    _held_rows(vec.row(), jx.row())
    _held_rows(ref.row(), jx.row())


# ---- bit for bit against the numpy core ------------------------------------


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
@pytest.mark.parametrize("kv", ["tight", "crush"])
def test_grid_policy_x_kv(policy, kv):
    _bit_for_bit(_scenario(_grid_trace(), policy=policy, spec=_spec(kv)))


@pytest.mark.parametrize("policy", ["aladdin", "po2"])
@pytest.mark.parametrize("kv", ["tight", "crush"])
def test_gamma_with_many_significant_bits(policy, kv):
    # gamma 0.3: l_in + gamma * l_real rounds, so the weighted context's
    # sums depend on their order (the numpy core's: ongoing rows in join
    # order, then the new batch)
    sc = _scenario(_grid_trace(), policy=policy, spec=_spec(kv), gamma=0.3)
    if policy == "aladdin":
        _bit_for_bit(sc)
    else:       # po2 compares weighted contexts, its draws are the port's
        runs = [_port_jax(sc) for _ in range(2)]
        assert runs[0][0].row() == runs[1][0].row()
        ref, _ = _port_reference(sc)
        assert runs[0][0].attainment == pytest.approx(ref.attainment,
                                                      abs=0.15)


def test_weighted_context_sums_in_join_order():
    # a hand-made chunk where constraint (c) holds with equality only when
    # the ongoing rows' weighted context is summed in join order, as the
    # numpy core sums it, and not in slot order
    args, kw = order_edge_chunk()
    nf, ni, fields = chunk_layout(kw["W"], kw["B"], kw["Q"])
    _, o_sst, _ = fields["sst"]
    _, o_rid, _ = fields["rid"]
    rows = kw["B"] - 2
    assert args[1][0, o_sst:o_sst + rows].eq(2).all()
    fo, io = chunk_plain(*args, **kw)
    assert int(io[0, fields["qlen"][1]]) == 0
    assert int(io[0, o_sst + rows]) == 2 and int(io[0, o_rid + rows]) == rows


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_preemption_resume_churn(policy):
    # KV crush: mid-decode evictions and FIFO resumes on every lane
    trace = generate_trace(WorkloadConfig(
        mean_rate=4.0, duration=25.0, seed=3, tail_frac=0.25,
        in_mu=5.0, out_mu=4.8, out_sigma=1.1))
    _bit_for_bit(_scenario(trace, policy=policy, spec=_spec("crush")))


def test_eviction_ties_go_to_the_earliest_joiner():
    # bursts of requests that arrive at one instant overflow the KV of one
    # lane: every eviction picks among rows of equal arrival, and resumes
    # pop them back in preemption order
    rng = np.random.default_rng(7)
    trace = [Request(l_in=int(rng.integers(100, 400)), l_pred=0,
                     l_real=int(rng.integers(150, 600)),
                     arrival=float(t))
             for t in (0.5, 3.0, 6.0) for _ in range(8)]
    _bit_for_bit(_scenario(trace, spec=_spec("crush"), n=1))
    _bit_for_bit(_scenario(trace, policy="jsq", spec=_spec("crush"), n=2))


SCALINGS = {
    "reactive": lambda: api.Reactive(interval=5.0, min_workers=2),
    "forecast": lambda: api.Forecast(period=30.0, min_workers=2),
    "feedback": lambda: api.FeedbackScale(
        base=api.Forecast(period=30.0, min_workers=2),
        min_gain=0.85, max_gain=1.3, boost=1.2, decay=0.02, window=20.0),
}


@pytest.mark.parametrize("scaling", sorted(SCALINGS))
def test_policy_scaled_fleet(scaling):
    sc = _scenario(_pooled_trace(), SCALINGS[scaling](), n=3)
    _bit_for_bit(sc)
    assert fastsim_jax.run_colocated_jax(sc, device="cpu").epochs["serve"]


def test_spot_fleet_with_notice():
    sspec = spot_variant(_spec("tight"), price=0.35,
                         preempt_hazard=1.0 / 60.0)
    events = preemption_trace(30.0, event_rate=1.0 / 8.0, frac=0.5, seed=13)
    sc = _scenario(_pooled_trace(seed=5), n=3, spec=sspec,
                   market=api.SpotMarket(sspec, events, notice_s=4.0))
    _bit_for_bit(sc)
    rep = fastsim_jax.run_colocated_jax(sc, device="cpu")
    assert rep.preempted_workers + rep.drained_ok > 0   # reclaims fired


def test_kv_scale_down_reclaim_chaos():
    # a KV-crushed spot fleet preempts rows mid-decode on the beats that
    # Reactive scale-downs drain lanes and market events kill them
    cspec = spot_variant(_spec("crush"), price=0.35,
                         preempt_hazard=1.0 / 60.0)
    events = preemption_trace(30.0, event_rate=1.0 / 6.0, frac=0.4, seed=2)
    sc = _scenario(_pooled_trace(seed=9, rate=5.0),
                   api.Reactive(interval=4.0, min_workers=1, max_workers=5),
                   n=3, spec=cspec, market=api.SpotMarket(cspec, events))
    _bit_for_bit(sc)
    jx, jx_t = _port_jax(sc)
    assert jx.preempted_workers > 0 and jx.requeued > 0
    assert any(r.preempt_count for r in jx_t)


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_single_tenant_pin(policy):
    # one tenant carrying the scenario's SLO: the tagged budgets equal the
    # planning SLO, so the floats are the scalar path's exactly
    trace = _grid_trace()
    tenants = [api.TenantSpec(name="solo", workload=lambda: trace,
                              slo=SLO_GRID)]
    merged = materialize_tenants(tenants)
    base, base_t = _port_jax(_scenario(trace, policy=policy))
    ten, ten_t = _port_jax(_scenario(merged, policy=policy,
                                     tenants=tenants))
    _held_requests(base_t, ten_t, exact=True)
    assert base.beats == ten.beats
    assert len(ten.tenant_rows) == 1
    assert ten.tenant_rows[0]["finished"] == base.finished
    _bit_for_bit(_scenario(merged, policy=policy, tenants=tenants))


# ---- at the reference grid's tolerances ------------------------------------


def _two_tenants():
    chat = api.TenantSpec(
        name="chat",
        workload=lambda: generate_trace(WorkloadConfig(
            mean_rate=2.0, duration=20.0, seed=17, tail_frac=0.2,
            in_mu=4.6, out_mu=4.2, out_sigma=1.0)),
        slo=SLO(ttft=0.6, atgt=0.060), priority=1, tier="interactive")
    ev = api.TenantSpec(
        name="eval",
        workload=lambda: generate_trace(WorkloadConfig(
            mean_rate=1.5, duration=20.0, seed=23, tail_frac=0.3,
            in_mu=5.0, out_mu=4.8, out_sigma=1.1)),
        slo=SLO(ttft=5.0, atgt=0.200), priority=0, tier="batch")
    return [chat, ev], materialize_tenants([chat, ev])


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_multi_tenant_matches_reference(policy):
    tenants, merged = _two_tenants()
    sc = _scenario(merged, policy=policy, tenants=tenants)
    jx, jx_t = _port_jax(sc)
    ref, ref_t = _port_reference(sc)
    vec, vec_t = _numpy_core(sc)
    assert ref.finished > 0
    for want_t, want in ((ref_t, ref), (vec_t, vec)):
        _held_requests(want_t, jx_t, exact=False)
        _held_rows(want.row(), jx.row())
        assert [r["tenant"] for r in jx.tenant_rows] == ["chat", "eval"]
        for wr, jr in zip(want.tenant_rows, jx.tenant_rows):
            _held_rows(wr, jr)
    assert [a.tenant for a in sorted(ref_t, key=lambda r: r.arrival)] \
        == [b.tenant for b in sorted(jx_t, key=lambda r: r.arrival)]


# ---- po2 ---------------------------------------------------------------------


def test_po2_deterministic_and_close_to_the_reference():
    sc = _scenario(_pooled_trace(), api.Reactive(interval=5.0,
                                                 min_workers=2),
                   policy="po2", n=3)
    runs = [_port_jax(sc) for _ in range(2)]
    assert runs[0][0].row() == runs[1][0].row()
    assert [(r.l_out, r.t_first_token, r.t_finish) for r in runs[0][1]] \
        == [(r.l_out, r.t_first_token, r.t_finish) for r in runs[1][1]]
    ref, _ = _port_reference(sc)
    assert runs[0][0].attainment == pytest.approx(ref.attainment, abs=0.15)
    assert runs[0][0].finished == ref.finished


# ---- the lockstep policy batch and optimize ------------------------------------


def _theta(sc, theta):
    return dataclasses.replace(
        sc, workload=clone_trace(sc.workload),
        topology=dataclasses.replace(sc.topology, theta=theta))


def test_policy_candidate_batch_matches_singles():
    base = _scenario(_pooled_trace(), api.Reactive(interval=5.0,
                                                   min_workers=2), n=3)
    thetas = (0.7, 0.85, 1.0)
    calls = []
    inner = fastsim_jax._run_chunks

    def count(sims, lens):
        calls.append(len(sims))
        return inner(sims, lens)

    fastsim_jax._run_chunks = count
    try:
        batch = fastsim_jax.run_policy_candidate_batch(
            [_theta(base, th) for th in thetas], device="cpu")
    finally:
        fastsim_jax._run_chunks = inner
    assert set(calls) == {3}            # every round: one launch, 3 CTAs
    for th, rep in zip(thetas, batch):
        single = fastsim_jax.run_colocated_jax(_theta(base, th),
                                               device="cpu")
        assert rep.row() == single.row()
        assert rep.beats == single.beats


def test_optimize_policy_space_matches_the_numpy_core(monkeypatch):
    # api.optimize reaches the compiled core with no device, i.e. the
    # card; here it is pointed at the plain version
    for name in ("run_colocated_jax", "run_policy_candidate_batch"):
        fn = getattr(fastsim_jax, name)
        monkeypatch.setattr(fastsim_jax, name,
                            lambda *a, _fn=fn, **k: _fn(*a, device="cpu",
                                                        **k))
    space = {"headroom": (0.9, 1.1), "theta": (0.8, 0.9)}
    plans = {}
    for engine in ("jax", "vectorized"):
        sc = _scenario(_pooled_trace(), api.Reactive(interval=5.0,
                                                     min_workers=2),
                       n=3, engine=engine)
        plans[engine] = api.optimize(sc, attain_target=0.99,
                                     policy_space=space)
    jx, vec = plans["jax"], plans["vectorized"]
    assert jx.params == vec.params
    assert jx.evals == vec.evals
    assert (jx.cost, jx.n_workers) == (vec.cost, vec.n_workers)
    _held_rows(vec.report.row(), jx.report.row())


def test_pooled_candidate_batch_runs_one_at_a_time():
    scs = [_scenario(_grid_trace(), spec=_spec("tight"), n=n)
           for n in (1, 2)]
    batch = fastsim_jax.run_candidate_batch(scs, device="cpu")
    for sc, rep in zip(scs, batch):
        vec, _ = _numpy_core(sc)
        assert rep.beats == vec.beats
        _held_rows(vec.row(), rep.row())


# ---- constraint (e) as the chunk kernel tests it -----------------------------


def _kv_peak_sorted(rem, ctx, rem_c, ctx_c, h, j):
    """The chunk kernel's constraint (e) peak (``kv_fits`` in chunk.cu):
    the members' rems ascending beside the suffix sums of their contexts,
    a term at the first member of each rem >= 1, at k = 1 for members with
    rem 0 and at the candidate's max(rem_c, 1), the candidate counted where
    its rem reaches k."""
    order = sorted(range(len(rem)), key=rem.__getitem__)
    rs = [rem[i] for i in order]
    m = len(rs)
    suf = [0] * (m + 1)
    for i in range(m - 1, -1, -1):
        suf[i] = suf[i + 1] + ctx[order[i]]
    terms = []

    def term(k, idx):
        cand = rem_c >= k
        cnt = (m - idx) + cand
        if cnt:
            terms.append(h * float(suf[idx] + (ctx_c if cand else 0)
                                   + cnt * k) + j * float(cnt))

    for q in range(m):
        if rs[q] >= 1 and (q == 0 or rs[q - 1] < rs[q]):
            term(rs[q], q)
    if rs.count(0):
        term(1, rs.count(0))
    kc = max(rem_c, 1)
    term(kc, sum(1 for r in rs if r < kc))
    best = max(terms, default=-math.inf)
    peak = h * float(suf[0] + ctx_c) + j * float(m + 1)
    return best if best > peak else peak


# Property-based when hypothesis is installed; otherwise the same property
# runs over the edge cases below and a fixed seed set, as in test_tenants.py
try:
    from hypothesis import example, given, settings
    from hypothesis import strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:                                    # pragma: no cover
    HAVE_HYPOTHESIS = False

# h and j with many significant bits among them
_KV_COEFS = (0.0, 1.0, 1 / 3, 0.3, 8.0, math.pi * 1e-3, 1 - 2 ** -52)
# (members as (rem, ctx), rem_c, ctx_c, h, j): an empty lane, rems of 0,
# equal rems, equal contexts
_KV_EDGES = [([], 0, 0, 1.0, 8.0), ([], 5, 300, 1 / 3, 0.3),
             ([(0, 10), (0, 20)], 0, 7, 0.3, 1 / 3),
             ([(3, 5), (3, 5), (3, 9)], 3, 5, 1 / 3, 0.3),
             ([(1, 2), (0, 4), (7, 4)], 1, 4, math.pi, 1 - 2 ** -52)]


def _kv_seeded(seed):
    rng = np.random.default_rng(seed)

    def coef():
        return (float(rng.choice(_KV_COEFS)) if rng.random() < 0.5
                else float(rng.uniform(0.0, 64.0)))

    members = [(int(rng.integers(0, 41)), int(rng.integers(0, 5001)))
               for _ in range(int(rng.integers(0, 41)))]
    return (members, int(rng.integers(0, 41)), int(rng.integers(0, 5001)),
            coef(), coef())


def _kv_peak_cases(fn):
    if not HAVE_HYPOTHESIS:
        return pytest.mark.parametrize(
            "members, rem_c, ctx_c, h, j",
            _KV_EDGES + [_kv_seeded(s) for s in range(64)])(fn)
    for case in _KV_EDGES:
        fn = example(*case)(fn)
    coef = hst.one_of(hst.sampled_from(_KV_COEFS),
                      hst.floats(0.0, 64.0, allow_nan=False))
    fn = given(members=hst.lists(hst.tuples(hst.integers(0, 40),
                                            hst.integers(0, 5000)),
                                 max_size=40),
               rem_c=hst.integers(0, 40), ctx_c=hst.integers(0, 5000),
               h=coef, j=coef)(fn)
    return settings(max_examples=400, deadline=None)(fn)


@_kv_peak_cases
def test_sorted_members_kv_peak_equals_kv_peak_arrays(members, rem_c, ctx_c,
                                                      h, j):
    # bit for bit (== on floats): integer sums are exact in any order and
    # every term keeps kv_peak_arrays' expression
    rem = [r for r, _ in members]
    ctx = [c for _, c in members]
    want = kv_peak_arrays(np.array(rem + [rem_c], np.int64),
                          np.array(ctx + [ctx_c], np.int64), h, j)
    assert _kv_peak_sorted(rem, ctx, rem_c, ctx_c, h, j) == want


def _lanes_turned_away(args, kw):
    """For the first queued request of a packed chunk state: the serving
    lanes that pass constraints (a)-(d), as the numpy core tests them for
    an untagged request, and of those the ones constraint (e) turns away
    (``kv_peak_arrays`` above theta * M)."""
    W, B, Q = kw["W"], kw["B"], kw["Q"]
    st = unpack_state(args[0][0].numpy(), args[1][0].numpy(), W, B, Q)
    l_in, l_real, s_lo = args[3], args[4], args[8][0]
    r = int(st["q"][0])
    liv, lrv, lov = int(l_in[r]), int(l_real[r]), int(s_lo[r])
    gamma, atgt, theta = kw["gamma"], kw["atgt"], float(st["theta"])
    sst, rli, rlr, rlo = (st[k] for k in ("sst", "rli", "rlr", "rlo"))
    feasible, turned = [], []
    for w in range(W):
        if st["mode"][w] != 2:
            continue
        lane = range(w * B, w * B + B)
        ongoing = sorted((s for s in lane if sst[s] == 2),
                         key=lambda s: st["rjsq"][s])
        new = sorted((s for s in lane if sst[s] == 1),
                     key=lambda s: st["rnsq"][s])
        wctx = 0.0
        for s in ongoing + new:
            wctx += int(rli[s]) + gamma * int(rlr[s])
        cnt = len(ongoing) + len(new)
        slack = min((atgt * max(int(rlo[s]) - 1, 0) - st["rtds"][s]
                     for s in ongoing), default=math.inf)
        k2, c2, c3 = st["K2"][w], st["C2"][w], st["C3"][w]
        budget = (max(((atgt - c3) - c2 * (cnt + 1)) / k2, 0.0)
                  if k2 > 0 else math.inf)
        pre_t = st["K1"][w] * (sum(int(rli[s]) for s in new) + liv) \
            + st["C1"][w]
        if not (cnt + 1 <= st["MAXB"][w]
                and wctx + (liv + gamma * lrv) <= theta * budget
                and pre_t <= kw["ttft"]
                and pre_t <= theta * max(slack, 0.0)):
            continue
        feasible.append(w)
        mem = ongoing + new
        rems = [max(int(rlr[s]) - int(rlo[s]), 0) for s in mem]
        ctxs = [int(rli[s]) + int(rlo[s]) for s in mem]
        peak = kv_peak_arrays(np.array(rems + [max(lrv - lov, 0)], np.int64),
                              np.array(ctxs + [liv + lov], np.int64),
                              st["H"][w], st["J"][w])
        if peak > theta * st["M"][w]:
            turned.append(w)
    return feasible, turned


def test_crush_e_walk_stresses_constraint_e():
    # the twin's first chunk: its first queued request passes (a)-(d) on at
    # least 4 lanes and constraint (e) turns every one of them away
    calls = chunk_twins.twin_chunks("crush-e-walk")
    feasible, turned = _lanes_turned_away(*calls[0][:2])
    assert len(turned) >= 4 and turned == feasible
    # and the plain run holds against the numpy core as the other twins do
    _bit_for_bit(chunk_twins.TWINS["crush-e-walk"]())


@pytest.mark.parametrize("case", ["chaos", "crush-jsq", "eviction-ties",
                                  "po2-reactive", "tenants-crush-aladdin"])
def test_widened_chunk_takes_the_same_decisions(case):
    # chunk_twins.widen moves a chunk into more lanes (off) and more slots
    # (free): the plain version then decides as before, so the card suite
    # can run the kernel on states whose member lists outgrow shared memory
    for args, kw, (fw, iw), _ in chunk_twins.twin_chunks(case):
        W, B, Q = kw["W"], kw["B"], kw["Q"]
        wide, kw2 = chunk_twins.widen(args, kw, W + 8, 2 * B)
        f2, i2 = chunk_plain(*wide, **kw2)
        want = unpack_state(fw[0].numpy(), iw[0].numpy(), W, B, Q)
        got = unpack_state(f2[0].numpy(), i2[0].numpy(), W + 8, 2 * B, Q)
        if want["ovf"]:             # the narrow chunk ran out of slots
            continue
        for name, v in want.items():
            g = got[name]
            if name in F_ROWS or name in I_ROWS:
                g = g.reshape(W + 8, 2 * B)[:W, :B].ravel()
            elif name in F_LANES or name in I_LANES:
                g = g[:W]
            np.testing.assert_array_equal(g, v, err_msg=name)


def test_chunk_counters_need_the_kernel():
    args, kw = order_edge_chunk()
    stats = torch.zeros((1, len(STATS)), dtype=torch.int64)
    with pytest.raises(ValueError, match="stats"):
        chunk(*args, **kw, stats=stats)


# ---- the plain version's units -----------------------------------------------


def _runs_equal(a, b) -> None:
    (ra, ta), (rb, tb) = a, b
    assert ra.row() == rb.row() and ra.beats == rb.beats
    _held_requests(ta, tb, exact=True)


def _sim_run(sc, shrink_rows=None, cut_every_beat=False, rerun=False):
    """Run ``sc`` through ``_PooledSim`` on the CPU, optionally starting
    with ``shrink_rows`` slots a lane, cutting a chunk at every beat, or
    running every chunk twice from the same packed state."""
    trace = clone_trace(sc.workload)
    sim = fastsim_jax._PooledSim(dataclasses.replace(sc, workload=trace),
                                 device="cpu")
    if shrink_rows is not None:         # lanes hold no rows yet
        for k in fastsim_jax._ROW_KEYS:
            sim.m[k] = sim.m[k][:, :shrink_rows].copy()
        sim.B = shrink_rows
    if cut_every_beat:
        sim._chunk_len = lambda: 1
    if rerun:
        inner = fastsim_jax._run_chunks

        def twice(sims, lens):
            first = inner(sims, lens)
            second = inner(sims, lens)
            for (f1, i1), (f2, i2) in zip(first, second):
                assert np.array_equal(i1, i2)
                assert np.array_equal(f1, f2, equal_nan=True)
            return second

        fastsim_jax._run_chunks = twice
    try:
        sim.run()
    finally:
        if rerun:
            fastsim_jax._run_chunks = inner
    return fastsim_jax._pooled_report(sim, writeback=True), trace, sim


def test_slot_overflow_regrowth_equals_enough_slots():
    sc = _scenario(_grid_trace(), spec=_spec("crush"))
    small = _sim_run(sc, shrink_rows=2)
    assert small[2].B > 2               # the chunks overflowed and regrew
    _runs_equal(_sim_run(sc)[:2], small[:2])


def test_po2_counter_survives_chunk_cuts_and_reruns():
    sc = _scenario(_pooled_trace(), policy="po2", n=3)
    whole = _sim_run(sc)
    assert whole[2].draws > 0 and whole[2].chunks == 1
    cut = _sim_run(sc, cut_every_beat=True)
    assert cut[2].chunks == whole[2].beat and cut[2].draws == whole[2].draws
    _runs_equal(whole[:2], cut[:2])
    _runs_equal(whole[:2], _sim_run(sc, cut_every_beat=True,
                                    rerun=True)[:2])


def test_cudaless_api_run_raises_the_device_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sc = _scenario(_grid_trace(), spec=_spec("tight"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run(sc)
    with pytest.raises(RuntimeError, match="CUDA"):
        fastsim_jax.run_policy_candidate_batch([sc, sc])


def test_chunk_layout_and_wrapper_checks():
    nf, ni, fields = chunk_layout(3, 4, 5)
    for buf, total in ((0, nf), (1, ni)):
        spans = sorted((off, size) for b, off, size in fields.values()
                       if b == buf)
        assert spans[0][0] == 0 and sum(s for _, s in spans) == total
        assert all(o1 + s1 == o2 for (o1, s1), (o2, _) in zip(spans,
                                                               spans[1:]))
    assert fields["q"] == (1, ni - 5, 5)
    f = torch.zeros((1, nf), dtype=torch.float64)
    i = torch.zeros((1, ni), dtype=torch.int64)
    trace = (torch.zeros(2, dtype=torch.float64),
             *(torch.zeros(2, dtype=torch.int64) for _ in range(3)),
             torch.zeros(2, dtype=torch.float64),
             torch.zeros(2, dtype=torch.float64))
    sinks = (torch.zeros((1, 2), dtype=torch.int64),
             torch.zeros((1, 3, 2), dtype=torch.float64))
    kw = dict(W=3, B=4, Q=5, hb=0.25, gamma=0.5, ttft=2.0, atgt=0.2,
              policy="aladdin")
    with pytest.raises(ValueError, match="state must be"):
        chunk(f[:, 1:], i, *trace, *sinks, **kw)
    with pytest.raises(ValueError, match="policy"):
        chunk(f, i, *trace, *sinks, **dict(kw, policy="rr"))
    with pytest.raises(ValueError, match="unsupported device"):
        chunk(f.to("meta"), i.to("meta"), *trace, *sinks, **kw)
    # K = 0: the candidate rides along and its state comes back unchanged
    fo, io = chunk_plain(f, i, *trace, *sinks, **kw)
    assert torch.equal(fo, f) and torch.equal(io, i)
