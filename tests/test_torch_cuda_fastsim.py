"""The Scenario API's compiled whole-trace core on the card.

The kernel (``kernels/fastsim/csrc/whole_trace.cu``) is held against its
plain version on the same inputs over the traces of
``tests/test_torch_fastsim.py``, a two-tenant trace whose backlog the EDF
sort reorders every beat, a heterogeneous fleet (per-worker coefficients
and max batches), a llama2-70b fleet at a 20 ms heartbeat, and a
40-worker x 32-slot bracket whose lane state needs more than 48 KB of
shared memory. Integers are held exactly, floats within ``rel=1e-12``
(the reference grid's per-request tolerance; the kernel is built to agree
bit for bit). Then ``run_candidate_batch`` on the card against single
runs, and ``optimize(engine="jax")`` against ``optimize(engine=
"vectorized")``.

These tests need an NVIDIA card and nvcc (the kernels are built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_fastsim.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.perf_model import (DecodeModel, KVModel,  # noqa: E402
                                         PerfModel, PrefillModel)
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import PAPER_SLOS, SLO  # noqa: E402
from repro_torch.core.worker_config import (A100_80G,  # noqa: E402
                                            WorkerSpec, make_worker_spec)
from repro_torch.kernels.fastsim import whole_trace  # noqa: E402
from repro_torch.serving import api, fastsim_jax  # noqa: E402
from repro_torch.serving.tenants import materialize_tenants  # noqa: E402
from repro_torch.serving.workload import (WorkloadConfig,  # noqa: E402
                                          clone_trace, diurnal_trace,
                                          generate_trace)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _jax_spec() -> WorkerSpec:
    perf = PerfModel(kv=KVModel(h=0.0, j=0.0),
                     prefill=PrefillModel(k1=2.2e-5, c1=8e-3),
                     decode=DecodeModel(k2=6e-6, c2=3.5e-4, c3=9e-3))
    return WorkerSpec(perf=perf, kv_capacity=1e18, max_batch=24,
                      n_accelerators=2, name="eq-jax")


def _llama70b_spec() -> WorkerSpec:
    # the reference's `scale` scenario worker: 4 A100s, max batch 32,
    # inert KV
    slo = PAPER_SLOS["llama2-70b"]
    base = make_worker_spec(get_arch("llama2-70b"), A100_80G, slo, n_g=4)
    return dataclasses.replace(base, max_batch=32, perf=PerfModel(
        prefill=base.perf.prefill, decode=base.perf.decode))


def _grid_trace():
    return generate_trace(WorkloadConfig(
        mean_rate=3.0, duration=20.0, seed=11, tail_frac=0.3,
        in_mu=4.6, out_mu=4.4, out_sigma=1.0))


def _two_tenants():
    chat = api.TenantSpec(
        name="chat",
        workload=lambda: generate_trace(WorkloadConfig(
            mean_rate=4.0, duration=20.0, seed=17, tail_frac=0.2,
            in_mu=4.6, out_mu=4.2, out_sigma=1.0)),
        slo=SLO(ttft=0.6, atgt=0.060), priority=1, tier="interactive")
    ev = api.TenantSpec(
        name="eval",
        workload=lambda: generate_trace(WorkloadConfig(
            mean_rate=4.0, duration=20.0, seed=23, tail_frac=0.3,
            in_mu=5.0, out_mu=4.8, out_sigma=1.1)),
        slo=SLO(ttft=5.0, atgt=0.200), priority=0, tier="batch")
    return [chat, ev], materialize_tenants([chat, ev])


def _diurnal(duration, seed=5):
    return diurnal_trace(WorkloadConfig(
        mean_rate=11.574, duration=duration, seed=seed, in_mu=5.0,
        in_sigma=1.1, out_mu=5.3, out_sigma=0.9), amplitude=0.6,
        period=duration)


def _scenario(trace, spec, n, policy, hb=0.25, slo=SLO(2.0, 0.2),
              tenants=None):
    return api.Scenario(
        workload=trace, fleet=api.FleetSpec([api.PoolSpec(spec, n)]),
        slo=slo, tenants=tenants,
        topology=api.Colocated(policy=policy, heartbeat=hb),
        scaling=api.FixedScale(), engine="jax")


def _heterogeneous(policy):
    big = WorkerSpec(perf=PerfModel(kv=KVModel(h=0.0, j=0.0),
                                    prefill=PrefillModel(k1=1.1e-5, c1=5e-3),
                                    decode=DecodeModel(k2=3e-6, c2=2.0e-4,
                                                       c3=6e-3)),
                     kv_capacity=1e18, max_batch=32, n_accelerators=4)
    trace = generate_trace(WorkloadConfig(
        mean_rate=4.0, duration=25.0, seed=2, tail_frac=0.25, in_mu=5.0,
        out_mu=4.8, out_sigma=1.1))
    return api.Scenario(
        workload=trace, fleet=api.FleetSpec([api.PoolSpec(_jax_spec(), 1),
                                             api.PoolSpec(big, 2)]),
        slo=SLO(2.0, 0.2), topology=api.Colocated(
            policy=policy, heartbeat=0.1, theta=0.8, gamma=0.25),
        scaling=api.FixedScale(), engine="jax"), 3


CASES = {
    "heterogeneous-aladdin": lambda: _heterogeneous("aladdin"),
    "heterogeneous-jsq": lambda: _heterogeneous("jsq"),
    "grid-aladdin": lambda: (_scenario(_grid_trace(), _jax_spec(), 2,
                                       "aladdin"), 2),
    "grid-jsq": lambda: (_scenario(_grid_trace(), _jax_spec(), 2, "jsq"),
                         2),
    "lone-arrival": lambda: (_scenario(
        [Request(l_in=96, l_pred=0, l_real=40, arrival=0.4)], _jax_spec(),
        2, "aladdin"), 2),
    "bracket": lambda: (_scenario(generate_trace(WorkloadConfig(
        mean_rate=6.0, duration=15.0, seed=5)), _jax_spec(), 6, "aladdin",
        slo=SLO(1.0, 0.1)), [2, 4, 6]),
    "tenants-edf-aladdin": lambda: (lambda ts: (_scenario(
        ts[1], _jax_spec(), 1, "aladdin", tenants=ts[0]), 1))(
            _two_tenants()),
    "tenants-edf-jsq": lambda: (lambda ts: (_scenario(
        ts[1], _jax_spec(), 1, "jsq", tenants=ts[0]), 1))(_two_tenants()),
    "llama70b-hb20ms": lambda: (_scenario(
        _diurnal(86.4), _llama70b_spec(), 3, "aladdin", hb=0.02,
        slo=PAPER_SLOS["llama2-70b"]), 3),
    "w40-bracket": lambda: (_scenario(
        _diurnal(43.2, seed=6), _llama70b_spec(), 40, "aladdin",
        slo=PAPER_SLOS["llama2-70b"]), [2, 3, 40]),
}


def _inputs(case, device):
    sc, n_active = CASES[case]()
    sc = api.resolve_scenario(sc)
    specs = fastsim_jax.check_jax_envelope(sc)
    ordered, arrival, l_in, l_real = fastsim_jax._trace_arrays(
        sc.materialize())
    multi = sc.tenants is not None and len(sc.tenants) > 1
    return fastsim_jax._kernel_inputs(sc, specs, ordered, arrival, l_in,
                                      l_real, n_active, device, edf=multi)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(card, case):
    args, statics = _inputs(case, "cpu")
    want = whole_trace(*args, **statics)
    before = whole_trace.launches
    got = whole_trace(*(a.to(card) for a in args), **statics)
    torch.cuda.synchronize()
    assert whole_trace.launches == before + 1
    for name, g, w in zip(("l_out", "t_decode_spent", "t_first_token",
                           "t_finish", "beats"), got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.int64:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0.0,
                                       equal_nan=True, msg=name)


def test_candidate_batch_matches_singles(card):
    trace = generate_trace(WorkloadConfig(mean_rate=6.0, duration=15.0,
                                          seed=5))
    scs = [_scenario(clone_trace(trace), _jax_spec(), n, "aladdin",
                     slo=SLO(1.0, 0.1)) for n in (2, 4, 6)]
    batch = fastsim_jax.run_candidate_batch(scs)
    for sc, rep in zip(scs, batch):
        single = api.run(dataclasses.replace(
            sc, workload=clone_trace(trace)))
        assert rep.row() == single.row()
        assert rep.beats == single.beats


def test_optimize_on_the_card_matches_the_numpy_core(card):
    trace = _diurnal(86.4)
    plans = {}
    for engine in ("jax", "vectorized"):
        sc = dataclasses.replace(
            _scenario(clone_trace(trace), _llama70b_spec(), 24, "aladdin",
                      slo=PAPER_SLOS["llama2-70b"]), engine=engine)
        plans[engine] = api.optimize(sc, attain_target=0.98, lo=1, hi=8)
    jx, vec = plans["jax"], plans["vectorized"]
    assert (jx.n_workers, jx.cost) == (vec.n_workers, vec.cost)
    assert jx.report.attainment == vec.report.attainment
    assert jx.report.finished == vec.report.finished
