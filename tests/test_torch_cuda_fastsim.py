"""The Scenario API's compiled cores on the card.

The kernel (``kernels/fastsim/csrc/whole_trace.cu``) is held against its
plain version on the same inputs over the traces of
``tests/test_torch_fastsim.py``, a two-tenant trace whose backlog the EDF
sort reorders every beat, a heterogeneous fleet (per-worker coefficients
and max batches), a llama2-70b fleet at a 20 ms heartbeat, and a
40-worker x 32-slot bracket whose lane state needs more than 48 KB of
shared memory, and an undersized llama2-70b fleet at the diurnal peak
whose long backlog the placement pass prunes (and the same with a
negative decode slope, which turns the pruning off, and a jsq fleet at
max batch 64, whose lanes hold more than a warp's members), and 128
workers x 32 slots and a jsq fleet of 64 x 64, whose members do not fit
in shared memory and live in the global scratch, and 1,300 workers at max
batch 1, whose lanes do not fit either. Integers are
held exactly, floats within ``rel=1e-12`` (the reference grid's
per-request tolerance; the kernel is built to agree bit for bit). Then
``run_candidate_batch`` on the card against single runs, and
``optimize(engine="jax")`` against ``optimize(engine="vectorized")``.
The kernel's counters (``stats``) change no result and must add up:
phases within the launch's cycles, beats as the kernel counts them,
placements within the requests.

The chunked core (``kernels/fastsim/csrc/chunk.cu``) is held against its
plain version chunk by chunk: each pooled twin of
``repro_torch.serving.chunk_twins`` (live KV with preemption churn,
policy-scaled fleets, a spot market with notice, the KV-crush chaos cell,
po2, two tenants, gamma 0.3, a best-fit walk that constraint (e) turns
away from lane after lane) runs on the CPU while every chunk's packed
state is recorded, and the kernel runs each recorded state; the advanced
states must agree exactly, and so must a hand-made chunk that only the
numpy core's summation order of the weighted context places. The same
chunks moved into 16 lanes of 512 slots run with the member lists in
global memory, and with the kernel's counters on, which must add up. Then whole
runs on the card against the numpy core
(request by request, beats, billed GPU-seconds), and
``run_policy_candidate_batch``'s lockstep launches against single runs.

These tests need an NVIDIA card and nvcc (the kernels are built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_fastsim.py
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.perf_model import (DecodeModel, KVModel,  # noqa: E402
                                         PerfModel, PrefillModel)
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import PAPER_SLOS, SLO  # noqa: E402
from repro_torch.core.worker_config import (A100_80G,  # noqa: E402
                                            WorkerSpec, make_worker_spec)
from repro_torch.kernels.fastsim import (STATS, WHOLE_STATS,  # noqa: E402
                                         chunk, chunk_layout,
                                         chunk_scratch_bytes, whole_trace,
                                         whole_trace_scratch_bytes)
from repro_torch.serving import api, chunk_twins, fastsim_jax  # noqa: E402
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


def _diurnal(duration, seed=5):
    return diurnal_trace(WorkloadConfig(
        mean_rate=11.574, duration=duration, seed=seed, in_mu=5.0,
        in_sigma=1.1, out_mu=5.3, out_sigma=0.9), amplitude=0.6,
        period=duration)


def _backlog_trace():
    # the `scale` trace's workload at its diurnal peak (11.574 req/s,
    # amplitude 0.6: ~18.5 req/s) for 20 s, far more than 2-3 llama2-70b
    # workers serve: the backlog grows to hundreds of untagged requests
    return diurnal_trace(WorkloadConfig(
        mean_rate=11.574, duration=20.0, seed=7, in_mu=5.0, in_sigma=1.1,
        out_mu=5.3, out_sigma=0.9), amplitude=0.6, period=8640.0,
        phase=math.pi / 2)


def _negative_c2_spec() -> WorkerSpec:
    # a decode time that falls with the batch: constraint (b) loosens as a
    # lane fills, so the placement pass may not prune
    spec = _llama70b_spec()
    d = spec.perf.decode
    return dataclasses.replace(spec, perf=PerfModel(
        prefill=spec.perf.prefill,
        decode=DecodeModel(k2=d.k2, c2=-1e-6, c3=d.c3)))


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
            chunk_twins.two_tenants()),
    "tenants-edf-jsq": lambda: (lambda ts: (_scenario(
        ts[1], _jax_spec(), 1, "jsq", tenants=ts[0]), 1))(chunk_twins.two_tenants()),
    "llama70b-hb20ms": lambda: (_scenario(
        _diurnal(86.4), _llama70b_spec(), 3, "aladdin", hb=0.02,
        slo=PAPER_SLOS["llama2-70b"]), 3),
    "w40-bracket": lambda: (_scenario(
        _diurnal(43.2, seed=6), _llama70b_spec(), 40, "aladdin",
        slo=PAPER_SLOS["llama2-70b"]), [2, 3, 40]),
    "backlog-llama70b": lambda: (_scenario(
        _backlog_trace(), _llama70b_spec(), 3, "aladdin",
        slo=PAPER_SLOS["llama2-70b"]), [2, 3]),
    "backlog-negative-c2": lambda: (_scenario(
        _backlog_trace(), _negative_c2_spec(), 3, "aladdin",
        slo=PAPER_SLOS["llama2-70b"]), [2, 3]),
    # jsq fills lanes to their max batch: 64 members, two chunks of a warp
    "backlog-jsq-b64": lambda: (_scenario(
        _backlog_trace(), dataclasses.replace(_llama70b_spec(),
                                              max_batch=64), 3, "jsq",
        slo=PAPER_SLOS["llama2-70b"]), [2, 3]),
    # lane state past shared memory: the members and tables go to the
    # global scratch (128 x 32 slots, best fit; 64 x 64, jsq over all)
    "w128-b32": lambda: (_scenario(
        _backlog_trace(), _llama70b_spec(), 128, "aladdin",
        slo=PAPER_SLOS["llama2-70b"]), [3, 128]),
    "w64-b64-jsq": lambda: (_scenario(
        _backlog_trace(), dataclasses.replace(_llama70b_spec(),
                                              max_batch=64), 64, "jsq",
        slo=PAPER_SLOS["llama2-70b"]), [2, 64]),
    # so many lanes that not even they fit in shared memory: all of the
    # lane state in the global scratch
    "w1300-b1": lambda: (_scenario(
        _backlog_trace(), dataclasses.replace(_llama70b_spec(), max_batch=1),
        1300, "aladdin", slo=PAPER_SLOS["llama2-70b"]), [1300]),
}

# the cases whose lane state lives in the global scratch; the rest fit in
# shared memory, the 40 x 32 bracket among them
GLOBAL_LANE_STATE = ("w128-b32", "w64-b64-jsq", "w1300-b1")


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
    n, maxb = int(args[0].shape[0]), statics["maxb"]
    queue = 16 * n                      # the queue's two buffers of keys
    in_global = whole_trace_scratch_bytes(n, len(maxb), max(maxb)) > queue
    assert in_global == (case in GLOBAL_LANE_STATE)
    for name, g, w in zip(("l_out", "t_decode_spent", "t_first_token",
                           "t_finish", "beats"), got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.int64:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=0.0,
                                       equal_nan=True, msg=name)


WHOLE_PHASES = ("admit", "try", "commit", "advance", "aggregate",
                "barrier")


@pytest.mark.parametrize("case", ["backlog-llama70b", "backlog-negative-c2",
                                  "backlog-jsq-b64", "grid-jsq",
                                  "tenants-edf-aladdin", "w40-bracket",
                                  "w128-b32", "w64-b64-jsq", "w1300-b1"])
def test_whole_trace_counters(card, case):
    args, statics = _inputs(case, card)
    want = whole_trace(*args, **statics)
    C, n = int(args[3].numel()), int(args[0].shape[0])
    stats = torch.zeros((C, len(WHOLE_STATS)), dtype=torch.int64,
                        device=card)
    got = whole_trace(*args, **statics, stats=stats)
    for g, w in zip(got, want):         # the counters change no result
        assert torch.equal(g.nan_to_num(-1.0), w.nan_to_num(-1.0))
    beats = got[4].reshape(C).tolist()
    done = (~got[3].reshape(C, n).isnan()).sum(dim=-1).tolist()
    rows = [dict(zip(WHOLE_STATS, r)) for r in stats.tolist()]
    for st, b, d in zip(rows, beats, done):
        phases = sum(st[f"{k}_cycles"] for k in WHOLE_PHASES)
        assert 0 < phases <= st["cycles"]
        assert st["beats"] == b
        assert 0 < st["iterations"] <= st["beats"]
        assert st["placed"] <= n
        if d == n:
            assert st["placed"] == n
        assert st["placed"] + st["dominated"] <= st["tried"]
        assert st["decode_segments"] <= st["decode_iterations"]
        assert st["prefills"] <= st["placed"]
    if case == "backlog-llama70b":      # the pruning decides tries
        assert all(st["dominated"] > 0 for st in rows)
    if case == "backlog-negative-c2":   # the guard turns it off
        assert all(st["dominated"] == 0 for st in rows)
    if case == "backlog-jsq-b64":       # full lanes settle the rest
        assert all(st["dominated"] > 0 for st in rows)


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


# ---- the chunked core --------------------------------------------------------


@pytest.mark.parametrize("case", sorted(chunk_twins.TWINS))
def test_chunk_kernel_matches_plain_version(card, case):
    calls = chunk_twins.twin_chunks(case)
    assert len(calls) >= 1
    for args, kw, (fw, iw), _ in calls:
        before = chunk.launches
        fg, ig = chunk(*(a.to(card) for a in args), **kw)
        torch.cuda.synchronize()
        assert chunk.launches == before + 1
        assert torch.equal(ig.cpu(), iw)
        torch.testing.assert_close(fg.cpu(), fw, rtol=0.0, atol=0.0,
                                   equal_nan=True)


def _held_chunk(got, want):
    fg, ig = got
    fw, iw = want
    assert torch.equal(ig.cpu(), iw)
    torch.testing.assert_close(fg.cpu(), fw, rtol=0.0, atol=0.0,
                               equal_nan=True)


@pytest.mark.parametrize("case", ["chaos", "eviction-ties", "po2-reactive",
                                  "tenants-crush-aladdin"])
def test_chunk_kernel_member_lists_in_global_memory(card, case):
    # every chunk moved into 16 lanes of 512 slots: the lanes' member lists
    # and the warps' scratch (chunk.cu's member_bytes) outgrow shared
    # memory and live in the wrapper's global scratch, with the same code
    for args, kw, _, _ in chunk_twins.twin_chunks(case):
        wide, kw2 = chunk_twins.widen(args, kw, max(kw["W"], 16), 512)
        assert chunk_scratch_bytes(kw2["W"], kw2["B"]) > 0
        got = chunk(*(a.to(card) for a in wide), **kw2)
        _held_chunk(got, chunk(*wide, **kw2))


@pytest.mark.parametrize("case", ["chaos", "crush-e-walk", "crush-jsq",
                                  "po2-reactive", "tenants-crush-aladdin"])
def test_chunk_kernel_counters(card, case):
    _, _, fields = chunk_layout(1, 1, 1)             # the scalars lead
    col = {k: fields[k][1] for k in ("j", "seqc")}
    for args, kw, want, _ in chunk_twins.twin_chunks(case):
        stats = torch.zeros((1, len(STATS)), dtype=torch.int64, device=card)
        got = chunk(*(a.to(card) for a in args), **kw, stats=stats)
        _held_chunk(got, want)          # the counters change no result
        st = dict(zip(STATS, stats[0].tolist()))
        phases = sum(st[f"{k}_cycles"] for k in (
            "admit", "aggregate", "place", "advance", "billing",
            "occupancy"))
        assert 0 <= phases <= st["cycles"]
        assert st["try_cycles"] + st["commit_cycles"] <= st["place_cycles"]
        delta = {k: int(want[1][0, c] - args[1][0, c])
                 for k, c in col.items()}
        assert st["beats"] == delta["j"]
        assert st["placed"] == delta["seqc"]
        assert st["placed"] <= st["any_lane"] <= st["tried"]
        assert st["any_lane"] + st["dominated"] <= st["tried"]
        if kw["policy"] == "aladdin":
            assert st["placed"] <= st["e_tests"]
            assert st["members"] <= st["e_tests"] * st["members_max"]
        else:
            assert st["e_tests"] == 0
        assert chunk_scratch_bytes(kw["W"], kw["B"]) == 0  # shared memory


def test_chunk_kernel_sums_weighted_context_in_join_order(card):
    args, kw = chunk_twins.order_edge_chunk()
    fw, iw = chunk(*args, **kw)
    fg, ig = chunk(*(a.to(card) for a in args), **kw)
    assert torch.equal(ig.cpu(), iw)
    torch.testing.assert_close(fg.cpu(), fw, rtol=0.0, atol=0.0,
                               equal_nan=True)
    _, _, fields = chunk_layout(kw["W"], kw["B"], kw["Q"])
    assert int(ig[0, fields["qlen"][1]]) == 0       # placed


def _held_bitwise(want, got):
    key = lambda r: (r.arrival, r.id)  # noqa: E731
    for a, b in zip(sorted(want, key=key), sorted(got, key=key)):
        assert (a.t_first_token, a.t_finish, a.l_out, a.t_decode_spent) \
            == (b.t_first_token, b.t_finish, b.l_out, b.t_decode_spent)


@pytest.mark.parametrize("case", ["chaos", "crush-aladdin-gamma-0.3",
                                  "feedback", "spot-notice",
                                  "tenants-crush-aladdin"])
def test_chunked_run_matches_the_numpy_core(card, case):
    sc = chunk_twins.TWINS[case]()
    jx_t, vec_t = clone_trace(sc.workload), clone_trace(sc.workload)
    before = chunk.launches
    jx = api.run(dataclasses.replace(sc, workload=jx_t))
    assert chunk.launches > before
    vec = api.run(dataclasses.replace(sc, workload=vec_t,
                                      engine="vectorized"))
    _held_bitwise(vec_t, jx_t)
    assert (jx.beats, jx.gpu_seconds, jx.preempted_workers,
            jx.drained_ok, jx.requeued) == (vec.beats, vec.gpu_seconds,
                                            vec.preempted_workers,
                                            vec.drained_ok, vec.requeued)


def test_policy_candidate_batch_on_the_card(card):
    trace = chunk_twins.trace(21, 3.0, 30.0)

    def mk(theta):
        sc = chunk_twins.scenario(clone_trace(trace), api.Reactive(
            interval=5.0, min_workers=2), n=3)
        return dataclasses.replace(
            sc, topology=dataclasses.replace(sc.topology, theta=theta))

    thetas = (0.7, 0.85, 1.0)
    before = chunk.launches
    batch = fastsim_jax.run_policy_candidate_batch([mk(t) for t in thetas])
    rounds = chunk.launches - before
    singles = [fastsim_jax.run_colocated_jax(mk(t)) for t in thetas]
    # one launch a round for all three: no more than the singles' launches
    assert 0 < rounds <= chunk.launches - before - rounds
    for rep, single in zip(batch, singles):
        assert rep.row() == single.row()
        assert rep.beats == single.beats
