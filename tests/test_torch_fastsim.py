"""The port's Scenario stack on the CPU: its compiled whole-trace core
(``repro_torch.serving.fastsim_jax``, through the kernel's plain version)
against the port's reference engine and the JAX package's numpy core on
the same traces, and the copied Scenario API against the JAX package's.

The whole-trace cells twin the ``engine="jax"`` cells of
``tests/test_fastsim_equivalence.py`` that fall inside the port's compiled
core (inert KV, fixed aladdin/jsq fleets). Tolerances are the reference
grid's: integers exact, per-request floats ``rel=1e-12``, report floats
``rel=1e-9``. Against the numpy core the per-request outcome is also held
bit for bit, and so is the beat count; a report's mean may differ in the
last ulp, because it averages over the finish order and requests that
finish at one instant may be listed in another order."""
import dataclasses
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as ref_serving  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core import A100_80G as REF_A100  # noqa: E402
from repro.core import PAPER_SLOS as REF_SLOS  # noqa: E402
from repro.core import make_worker_spec as ref_make_spec  # noqa: E402
from repro.core.request import ReqState as RefReqState  # noqa: E402
from repro.core.worker_config import spot_variant as ref_spot  # noqa: E402
from repro.serving import api as ref_api  # noqa: E402
from repro.serving import workload as ref_workload  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.perf_model import (DecodeModel, KVModel,  # noqa: E402
                                         PerfModel, PrefillModel)
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import PAPER_SLOS, SLO  # noqa: E402
from repro_torch.core.worker_config import (A100_80G,  # noqa: E402
                                            WorkerSpec, make_worker_spec,
                                            spot_variant)
from repro_torch.kernels.fastsim import (whole_trace,  # noqa: E402
                                         whole_trace_plain)
from repro_torch.serving import api, fastsim_jax  # noqa: E402
from repro_torch.serving.tenants import materialize_tenants  # noqa: E402
from repro_torch.serving.workload import (PreemptionEvent,  # noqa: E402
                                          WorkloadConfig, clone_trace,
                                          generate_trace)

SLO_GRID = SLO(ttft=2.0, atgt=0.2)
PART2 = "A12 part 2"


def _jax_spec() -> WorkerSpec:
    # inert KV (h == j == 0): the whole-trace core's envelope
    perf = PerfModel(kv=KVModel(h=0.0, j=0.0),
                     prefill=PrefillModel(k1=2.2e-5, c1=8e-3),
                     decode=DecodeModel(k2=6e-6, c2=3.5e-4, c3=9e-3))
    return WorkerSpec(perf=perf, kv_capacity=1e18, max_batch=24,
                      n_accelerators=2, name="eq-jax")


def _tight_spec() -> WorkerSpec:
    perf = PerfModel(kv=KVModel(h=1.0, j=16.0),
                     prefill=PrefillModel(k1=2.2e-5, c1=8e-3),
                     decode=DecodeModel(k2=6e-6, c2=3.5e-4, c3=9e-3))
    return WorkerSpec(perf=perf, kv_capacity=6000.0, max_batch=24,
                      n_accelerators=2, name="eq-tight")


def _grid_trace():
    return generate_trace(WorkloadConfig(
        mean_rate=3.0, duration=20.0, seed=11, tail_frac=0.3,
        in_mu=4.6, out_mu=4.4, out_sigma=1.0))


def _scenario(trace, pools, policy, engine, **kw):
    return api.Scenario(
        workload=trace, fleet=api.FleetSpec(pools), slo=SLO_GRID,
        topology=api.Colocated(policy=policy), scaling=api.FixedScale(),
        seed=0, engine=engine, **kw)


def _ref_vectorized(scenario):
    """The same scenario through the JAX package's numpy core: the trace
    is rebuilt there from the port's requests, field for field."""
    trace = [ref_workload.Request(**{
        f.name: (RefReqState[r.state.name] if f.name == "state"
                 else getattr(r, f.name)) for f in dataclasses.fields(r)})
        for r in scenario.workload]
    ref_topo = ref_api.Colocated(**dataclasses.asdict(scenario.topology))
    ref_pools = [ref_api.PoolSpec(p.spec, p.count)
                 for p in scenario.fleet.pools]
    tenants = None
    if scenario.tenants is not None:
        tenants = [ref_api.TenantSpec(**{f.name: getattr(t, f.name)
                                         for f in dataclasses.fields(t)})
                   for t in scenario.tenants]
    rep = ref_api.run(ref_api.Scenario(
        workload=trace, fleet=ref_api.FleetSpec(ref_pools),
        slo=scenario.slo, topology=ref_topo, scaling=ref_api.FixedScale(),
        tenants=tenants, seed=scenario.seed, engine="vectorized"))
    return rep, trace


def _same(a, b) -> bool:
    return (a is None and b is None) or a == b


def _assert_requests(want, got, exact: bool) -> None:
    key = lambda r: (r.arrival, r.id)  # noqa: E731
    assert len(want) == len(got)
    for a, b in zip(sorted(want, key=key), sorted(got, key=key)):
        assert a.l_out == b.l_out
        assert (a.t_finish is None) == (b.t_finish is None)
        assert (a.t_first_token is None) == (b.t_first_token is None)
        if exact:
            assert _same(a.t_first_token, b.t_first_token)
            assert _same(a.t_finish, b.t_finish)
            assert a.t_decode_spent == b.t_decode_spent
            continue
        if a.t_first_token is not None:
            assert b.t_first_token == pytest.approx(a.t_first_token,
                                                    rel=1e-12)
        if a.t_finish is not None:
            assert b.t_finish == pytest.approx(a.t_finish, rel=1e-12)
            assert b.t_decode_spent == pytest.approx(a.t_decode_spent,
                                                     rel=1e-12)


def _assert_rows(want: dict, got: dict, rel: float = 1e-9) -> None:
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


def _run_three(trace, pools, policy, **kw):
    """The port's compiled core (plain version), the port's reference
    engine and the JAX package's numpy core on one trace."""
    jx_t, ref_t = clone_trace(trace), clone_trace(trace)
    jx = fastsim_jax.run_colocated_jax(
        _scenario(jx_t, pools, policy, "jax", **kw), device="cpu")
    ref = api.run(_scenario(ref_t, pools, policy, "reference", **kw))
    vec, vec_t = _ref_vectorized(
        _scenario(clone_trace(trace), pools, policy, "vectorized", **kw))
    return (jx, jx_t), (ref, ref_t), (vec, vec_t)


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_jax_engine_matches_reference(policy):
    (jx, jx_t), (ref, ref_t), (vec, vec_t) = _run_three(
        _grid_trace(), [api.PoolSpec(_jax_spec(), 2)], policy)
    assert ref.finished > 0
    _assert_requests(ref_t, jx_t, exact=False)
    assert jx.finished == ref.finished
    assert jx.attainment == pytest.approx(ref.attainment)
    assert jx.p99_atgt == pytest.approx(ref.p99_atgt, rel=1e-9)
    assert jx.p99_ttft == pytest.approx(ref.p99_ttft, rel=1e-9)
    _assert_requests(vec_t, jx_t, exact=True)
    _assert_rows(vec.row(), jx.row())
    assert jx.beats == vec.beats


def _big_inert_spec() -> WorkerSpec:
    perf = PerfModel(kv=KVModel(h=0.0, j=0.0),
                     prefill=PrefillModel(k1=1.1e-5, c1=5e-3),
                     decode=DecodeModel(k2=3e-6, c2=2.0e-4, c3=6e-3))
    return WorkerSpec(perf=perf, kv_capacity=1e18, max_batch=32,
                      n_accelerators=4, name="eq-big")


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_jax_engine_heterogeneous_fleet(policy):
    # per-worker coefficients and max batches (a lane of 24 slots beside
    # lanes of 32), and non-default heartbeat, theta and gamma
    trace = generate_trace(WorkloadConfig(
        mean_rate=4.0, duration=25.0, seed=2, tail_frac=0.25,
        in_mu=5.0, out_mu=4.8, out_sigma=1.1))
    pools = [api.PoolSpec(_jax_spec(), 1), api.PoolSpec(_big_inert_spec(),
                                                         2)]
    topo = api.Colocated(policy=policy, heartbeat=0.1, theta=0.8,
                         gamma=0.25)
    jx_t, ref_t, vec_t = (clone_trace(trace) for _ in range(3))
    mk = lambda t, e: dataclasses.replace(  # noqa: E731
        _scenario(t, pools, policy, e), topology=topo)
    jx = fastsim_jax.run_colocated_jax(mk(jx_t, "jax"), device="cpu")
    ref = api.run(mk(ref_t, "reference"))
    vec, vec_t = _ref_vectorized(mk(vec_t, "vectorized"))
    assert ref.finished > 0
    _assert_requests(ref_t, jx_t, exact=False)
    _assert_rows(ref.row(), jx.row())
    _assert_requests(vec_t, jx_t, exact=True)
    _assert_rows(vec.row(), jx.row())
    assert jx.beats == vec.beats


@pytest.mark.parametrize("n_req", [0, 1])
def test_jax_engine_edge_traces(n_req):
    # the beat loop on an empty trace (no kernel at all) and a lone
    # arrival (the event skip covers the whole tail gap, and the final
    # drain's beats stop at the beat of its finish)
    trace = [Request(l_in=96, l_pred=0, l_real=40, arrival=0.4)][:n_req]
    for policy in ("aladdin", "jsq"):
        (jx, jx_t), (ref, ref_t), (vec, vec_t) = _run_three(
            trace, [api.PoolSpec(_jax_spec(), 2)], policy)
        assert jx.total == ref.total == n_req
        assert jx.finished == ref.finished == n_req
        _assert_requests(ref_t, jx_t, exact=False)
        _assert_requests(vec_t, jx_t, exact=True)
        _assert_rows(vec.row(), jx.row())
        if n_req:       # an empty trace runs no beat loop, as in the jit core
            assert jx.beats == vec.beats
            assert jx_t[0].t_first_token >= 0.4


def test_jax_candidate_batch_matches_singles():
    trace = generate_trace(WorkloadConfig(mean_rate=6.0, duration=15.0,
                                          seed=5))
    slo = SLO(ttft=1.0, atgt=0.1)
    scs = [api.Scenario(
        workload=clone_trace(trace),
        fleet=api.FleetSpec([api.PoolSpec(_jax_spec(), n)]), slo=slo,
        topology=api.Colocated(policy="aladdin"),
        scaling=api.FixedScale(), engine="jax") for n in (2, 4, 6)]
    batch = fastsim_jax.run_candidate_batch(scs, device="cpu")
    assert [r.peak_workers for r in batch] == [2, 4, 6]
    for sc, rep in zip(scs, batch):
        single = fastsim_jax.run_colocated_jax(
            dataclasses.replace(sc, workload=clone_trace(trace)),
            device="cpu")
        assert rep.row() == single.row()
        assert rep.beats == single.beats
        vec, _ = _ref_vectorized(dataclasses.replace(
            sc, workload=clone_trace(trace), engine="vectorized"))
        _assert_rows(vec.row(), rep.row())
        assert rep.beats == vec.beats


def _solo_tenants(trace, slo=SLO_GRID):
    tenants = [api.TenantSpec(name="solo", workload=lambda: trace,
                              slo=slo)]
    return tenants, materialize_tenants(tenants)


def _two_tenants(rate=(2.0, 1.5)):
    chat = api.TenantSpec(
        name="chat",
        workload=lambda: generate_trace(WorkloadConfig(
            mean_rate=rate[0], duration=20.0, seed=17, tail_frac=0.2,
            in_mu=4.6, out_mu=4.2, out_sigma=1.0)),
        slo=SLO(ttft=0.6, atgt=0.060), priority=1, tier="interactive")
    ev = api.TenantSpec(
        name="eval",
        workload=lambda: generate_trace(WorkloadConfig(
            mean_rate=rate[1], duration=20.0, seed=23, tail_frac=0.3,
            in_mu=5.0, out_mu=4.8, out_sigma=1.1)),
        slo=SLO(ttft=5.0, atgt=0.200), priority=0, tier="batch")
    tenants = [chat, ev]
    return tenants, materialize_tenants(tenants)


def _tenant_scenario(merged, tenants, pools, policy, engine):
    return api.Scenario(
        workload=merged, fleet=api.FleetSpec(pools), tenants=tenants,
        topology=api.Colocated(policy=policy), scaling=api.FixedScale(),
        engine=engine)


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_single_tenant_pin_jax(policy):
    # a single tenant flips the tagged/EDF flags off: the floats are the
    # scalar path's exactly
    trace = _grid_trace()
    tenants, merged = _solo_tenants(trace)
    pools = [api.PoolSpec(_jax_spec(), 2)]
    base_t = clone_trace(trace)
    base = fastsim_jax.run_colocated_jax(
        _scenario(base_t, pools, policy, "jax"), device="cpu")
    ten_t = clone_trace(merged)
    ten = fastsim_jax.run_colocated_jax(
        _tenant_scenario(ten_t, tenants, pools, policy, "jax"),
        device="cpu")
    _assert_requests(base_t, ten_t, exact=True)
    assert base.row() == ten.row()
    assert len(ten.tenant_rows) == 1
    assert ten.tenant_rows[0]["finished"] == base.finished


@pytest.mark.parametrize("rate,n", [((2.0, 1.5), 2), ((4.0, 4.0), 1)])
@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_multi_tenant_jax_matches_reference(policy, rate, n):
    # EDF admission order and per-request tagged budgets; the congested
    # case keeps a backlog that the EDF sort reorders every beat
    tenants, merged = _two_tenants(rate)
    pools = [api.PoolSpec(_jax_spec(), n)]
    sc = _tenant_scenario(clone_trace(merged), tenants, pools, policy,
                          "jax")
    assert fastsim_jax._legacy_ok(api.resolve_scenario(sc),
                                  [_jax_spec()] * n)
    jx_t, ref_t = clone_trace(merged), clone_trace(merged)
    jx = fastsim_jax.run_colocated_jax(
        _tenant_scenario(jx_t, tenants, pools, policy, "jax"),
        device="cpu")
    ref = api.run(_tenant_scenario(ref_t, tenants, pools, policy,
                                   "reference"))
    vec, vec_t = _ref_vectorized(_tenant_scenario(
        clone_trace(merged), tenants, pools, policy, "vectorized"))
    assert ref.finished > 0
    _assert_requests(ref_t, jx_t, exact=False)
    _assert_requests(vec_t, jx_t, exact=True)
    assert [a.tenant for a in sorted(ref_t, key=lambda r: r.arrival)] \
        == [b.tenant for b in sorted(jx_t, key=lambda r: r.arrival)]
    _assert_rows(ref.row(), jx.row())
    _assert_rows(vec.row(), jx.row())
    assert [r["tenant"] for r in jx.tenant_rows] == ["chat", "eval"]
    for want in (ref.tenant_rows, vec.tenant_rows):
        for wr, jr in zip(want, jx.tenant_rows):
            _assert_rows(wr, jr)


def _out_of_envelope():
    sspec = spot_variant(_jax_spec(), price=0.35,
                         preempt_hazard=1.0 / 100.0)
    market = api.SpotMarket(sspec, [PreemptionEvent(t=3.0, frac=0.5)])
    return {
        "live_kv": dict(pools=[api.PoolSpec(_tight_spec(), 2)]),
        "po2": dict(policy="po2"),
        "scaled": dict(scaling=api.Reactive(interval=5.0, min_workers=2)),
        "market": dict(market=market,
                       pools=[api.PoolSpec(_jax_spec(), 1),
                              api.PoolSpec(sspec, 1)]),
    }


@pytest.mark.parametrize("feature", ["live_kv", "po2", "scaled", "market"])
def test_out_of_envelope_raises_not_implemented(feature):
    kw = dict(_out_of_envelope()[feature])
    pools = kw.pop("pools", [api.PoolSpec(_jax_spec(), 2)])
    policy = kw.pop("policy", "aladdin")
    sc = _scenario(_grid_trace(), pools, policy, "jax")
    sc = dataclasses.replace(sc, **kw)
    with pytest.raises(NotImplementedError, match=PART2):
        fastsim_jax.run_colocated_jax(sc, device="cpu")
    with pytest.raises(NotImplementedError, match=PART2):
        fastsim_jax.run_candidate_batch([sc, sc], device="cpu")
    # the numpy core runs it
    assert api.run(dataclasses.replace(sc, engine="vectorized")).total > 0


def test_policy_candidate_batch_not_implemented():
    sc = _scenario(_grid_trace(), [api.PoolSpec(_jax_spec(), 2)],
                   "aladdin", "jax")
    with pytest.raises(NotImplementedError, match=PART2):
        fastsim_jax.run_policy_candidate_batch([sc, sc], device="cpu")


def test_empty_non_legacy_trace_uses_the_numpy_core():
    sc = _scenario([], [api.PoolSpec(_jax_spec(), 2)], "aladdin", "jax",
                   )
    sc = dataclasses.replace(sc, scaling=api.Reactive(interval=5.0,
                                                      min_workers=2))
    jx = fastsim_jax.run_colocated_jax(sc, device="cpu")
    vec = api.run(dataclasses.replace(sc, engine="vectorized"))
    assert jx.total == vec.total == 0
    _assert_rows(vec.row(), jx.row(), rel=0.0)


# ---- the kernel's plain version -----------------------------------------


def _statics(W=2, policy="aladdin", B=4):
    return dict(hb=0.25, horizon=60.0, theta=0.9, gamma=0.5, ttft=2.0,
                atgt=0.2, policy=policy,
                coefs=((2.2e-5,) * W, (8e-3,) * W, (6e-6,) * W,
                       (3.5e-4,) * W, (9e-3,) * W),
                maxb=(B,) * W, maxb_norm=(B,) * W, cmax_norm=(5e4,) * W)


def _trace_tensors(n=12, seed=3):
    rng = np.random.default_rng(seed)
    arrival = np.sort(rng.uniform(0.0, 8.0, n))
    l_in = rng.integers(16, 400, n)
    l_real = rng.integers(1, 200, n)
    rank = np.arange(n)
    inf = np.full(n, np.inf)
    return (torch.tensor(arrival), torch.tensor(l_in), torch.tensor(l_real),
            torch.tensor(rank), torch.tensor(inf), torch.tensor(inf))


@pytest.mark.parametrize("policy", ["aladdin", "jsq"])
def test_plain_version_batch_equals_singles(policy):
    arrival, l_in, l_real, rank, ttft_r, atgt_r = _trace_tensors()
    kw = _statics(W=3, policy=policy)
    batch = whole_trace(arrival, l_in, l_real, torch.tensor([1, 2, 3]),
                        rank, ttft_r, atgt_r, **kw)
    assert batch[0].shape == (3, 12) and batch[4].shape == (3,)
    for c, na in enumerate((1, 2, 3)):
        one = whole_trace(arrival, l_in, l_real, na, rank, ttft_r, atgt_r,
                          **kw)
        for got, want in zip((b[c] for b in batch), one):
            assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))
    # every request placed in time finishes; none is lost
    lo, _tds, tf1, tfn, beats = batch
    assert bool((lo[2] >= l_real).all()) and not tfn[2].isnan().any()
    assert bool((tfn[2] >= tf1[2]).all()) and int(beats[2]) > 0


def test_plain_version_unset_times_are_nan():
    # one worker, max batch 1, a horizon that cuts the tail: requests that
    # are never placed keep NaN first-token and finish times and l_out 0
    arrival, l_in, l_real, rank, ttft_r, atgt_r = _trace_tensors(n=12)
    kw = dict(_statics(W=1, policy="jsq", B=1), horizon=0.5)
    lo, tds, tf1, tfn, _beats = whole_trace(
        arrival, l_in, l_real, 1, rank, ttft_r, atgt_r, **kw)
    unplaced = tf1.isnan()
    assert bool(unplaced.any())
    assert bool((lo[unplaced] == 0).all())
    assert bool((tds[unplaced] == 0.0).all())
    assert bool(tfn[unplaced].isnan().all())


def test_wrapper_refuses_other_devices_and_bad_statics():
    arrival, l_in, l_real, rank, ttft_r, atgt_r = _trace_tensors()
    meta = [x.to("meta") for x in (arrival, l_in, l_real, rank, ttft_r,
                                   atgt_r)]
    with pytest.raises(ValueError, match="unsupported device"):
        whole_trace(meta[0], meta[1], meta[2], 1, *meta[3:], **_statics())
    with pytest.raises(ValueError, match="policy"):
        whole_trace(arrival, l_in, l_real, 1, rank, ttft_r, atgt_r,
                    **dict(_statics(), policy="po2"))
    with pytest.raises(ValueError, match="empty"):
        whole_trace_plain(arrival[:0], l_in[:0], l_real[:0], 1, rank[:0],
                          ttft_r[:0], atgt_r[:0], **_statics())


def _device_hypot(a: float, b: float) -> float:
    """The capacity norm as ``csrc/whole_trace.cu`` computes it:
    CPython's ``math.hypot`` algorithm (scaling by a power of two, exact
    squares as double-length products, a compensated sum, one correction
    step), with the exact product's low part taken here from fractions
    where the kernel takes it from one fused multiply-add."""
    from fractions import Fraction

    def two_prod(x, y):
        hi = x * y
        return hi, float(Fraction(x) * Fraction(y) - Fraction(hi))

    mx = max(abs(a), abs(b))
    if mx == 0.0:
        return mx
    scale = math.ldexp(1.0, -math.frexp(mx)[1])
    csum, f1, f2 = 1.0, 0.0, 0.0
    for x in (abs(a) * scale, abs(b) * scale):
        ph, pl = two_prod(x, x)
        hi = csum + ph
        f2 += (csum - hi) + ph
        csum = hi
        f1 += pl
    h = math.sqrt(csum - 1.0 + (f1 + f2))
    ph, pl = two_prod(-h, h)
    hi = csum + ph
    f2 += (csum - hi) + ph
    csum = hi
    f1 += pl
    h += (csum - 1.0 + (f1 + f2)) / (2.0 * h)
    return h / scale


def test_device_capacity_norm_is_cpythons_hypot():
    rng = random.Random(0)
    for _ in range(20000):
        cnt, mb = rng.randint(0, 40), rng.choice([1, 7, 24, 32, 128])
        wctx, cmax = rng.randint(0, 200000) * 0.5, rng.uniform(1.0, 3e5)
        a, b = cnt / mb, wctx / cmax
        assert _device_hypot(a, b) == math.hypot(a, b)
        a, b = rng.random(), rng.random() * 10.0 ** rng.randint(-6, 6)
        assert _device_hypot(a, b) == math.hypot(a, b)


# ---- the copied Scenario API against the JAX package's ------------------


def test_public_surface_equals_the_reference():
    assert port_serving.__all__ == ref_serving.__all__
    for name in port_serving.__all__:
        assert hasattr(port_serving, name), name


WCFG = dict(mean_rate=2.0, duration=10.0, seed=5, in_mu=5.0, in_sigma=1.1,
            out_mu=5.3, out_sigma=0.9)


def _cell(pkg, arch, a100, slos, make, spot, kind, engine):
    """One cell of ``tests/test_scenario_api.py``'s matrix, built from one
    package's own modules."""
    slo = slos["llama2-70b"]
    spec = make(arch("llama2-70b"), a100, slo, mean_context=450.0)
    cfg = pkg.WorkloadConfig(**WCFG)
    market = None
    if kind == "disagg":
        topo = pkg.Disaggregated()
        fleet = pkg.FleetSpec([pkg.PoolSpec(spec, 2, role="prefill"),
                               pkg.PoolSpec(spec, 3, role="decode")])
    else:
        topo = pkg.Colocated()
        fleet = pkg.FleetSpec([pkg.PoolSpec(spec, 3)])
    scaling = pkg.FixedScale()
    if kind == "autoscaled":
        scaling = pkg.Reactive(interval=2.0, provision_delay=2.0)
    if kind == "spot":
        sspec = spot(spec, price=0.35, preempt_hazard=1.0 / 100.0)
        fleet = pkg.FleetSpec([pkg.PoolSpec(spec, 3),
                               pkg.PoolSpec(sspec, 2)])
        market = pkg.SpotMarket(sspec, [pkg.PreemptionEvent(t=3.0, frac=0.5),
                                        pkg.PreemptionEvent(t=7.0, frac=0.5)])
    return pkg.Scenario(workload=lambda: pkg.generate_trace(cfg),
                        fleet=fleet, slo=slo, topology=topo,
                        scaling=scaling, market=market, engine=engine)


def _both_cells(kind, engine):
    port = _cell(port_serving, get_arch, A100_80G, PAPER_SLOS,
                 make_worker_spec, spot_variant, kind, engine)
    ref = _cell(ref_serving, ref_get_arch, REF_A100, REF_SLOS,
                ref_make_spec, ref_spot, kind, engine)
    return port, ref


def _rows_bitwise(want: dict, got: dict) -> None:
    assert want.keys() == got.keys()
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert w == g, k


@pytest.mark.parametrize("kind,engine", [
    ("colocated", "reference"), ("colocated", "vectorized"),
    ("disagg", "reference"), ("autoscaled", "reference"),
    ("autoscaled", "vectorized"), ("spot", "vectorized")])
def test_run_matches_the_reference_package(kind, engine):
    port, ref = _both_cells(kind, engine)
    _rows_bitwise(ref_api.run(ref).row(), api.run(port).row())


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
def test_optimize_matches_the_reference_package(engine):
    port, ref = _both_cells("colocated", engine)
    want = ref_api.optimize(ref, attain_target=0.95, lo=1, hi=8)
    got = api.optimize(port, attain_target=0.95, lo=1, hi=8)
    assert (got.n_workers, got.cost, got.evals) \
        == (want.n_workers, want.cost, want.evals)
    _rows_bitwise(want.report.row(), got.report.row())


def test_jax_engine_refuses_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _scenario(_grid_trace(), [api.PoolSpec(_jax_spec(), 2)],
                   "aladdin", "jax")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run(sc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.optimize(sc, attain_target=0.95, lo=1, hi=4)
