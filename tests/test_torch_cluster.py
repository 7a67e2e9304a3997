"""The port's ServingCluster on the CPU: a twin of the reference's end-to-end
serving-loop test (tests/test_system.py), and lock-step agreement with the
JAX ServingCluster under one deterministic counter clock — same finish
heartbeats, same worker ids, same tokens, same fitted Eq. 1-3
coefficients. That pins the copied Algorithm 1/2 and Eq. 1-3 code and the
engine's clock reads together."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.request import ReqState as JaxReqState  # noqa: E402
from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.core.slo import SLO as JaxSLO  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving import cluster as jax_cluster  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.core.request import ReqState, Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.core.perf_model import analytic_perf_model  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.cluster import (ClusterConfig,  # noqa: E402
                                         ServingCluster)
from repro_torch.serving.engine import EngineConfig  # noqa: E402

ENGINE_KW = dict(max_batch=4, page_size=8, n_pages=96, max_pages_per_seq=8)


def _cluster(policy="aladdin", n_workers=2, max_batch=4):
    arch = reduced(get_arch("llama2-7b"), n_layers=2, d_model=48, vocab=96)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    return arch, ServingCluster(
        arch, params, SLO(ttft=30.0, atgt=5.0),
        engine_cfg=EngineConfig(**dict(ENGINE_KW, max_batch=max_batch)),
        cfg=ClusterConfig(policy=policy), n_workers=n_workers, device="cpu")


def _mk_req(rng, arch):
    r = Request(l_in=int(rng.integers(6, 24)), l_pred=0,
                l_real=int(rng.integers(3, 8)), arrival=time.perf_counter())
    r.tokens = [int(x) for x in rng.integers(2, arch.vocab, r.l_in)]
    return r


def test_full_serving_loop_end_to_end():
    """Submit a stream, run the control loop, verify every request finishes
    with coherent bookkeeping and the perf model was fitted from traces."""
    arch, cluster = _cluster()
    rng = np.random.default_rng(0)
    reqs = [_mk_req(rng, arch) for _ in range(10)]
    for r in reqs:
        cluster.submit(r)
        cluster.heartbeat()
    cluster.run_until_drained(max_beats=300)
    assert all(r.state == ReqState.FINISHED for r in reqs)
    assert all(len(r.tokens) == r.l_in + r.l_out for r in reqs)
    assert all(r.t_first_token is not None and r.t_finish is not None
               for r in reqs)
    # traces fitted the decode model (workflow step 3)
    assert cluster.perf.decode.k2 != 0.0 or cluster.perf.decode.c2 != 0.0
    # predictor learned from completions
    assert cluster.predictor.predict(16) > 0


def test_failure_snapshot_and_restore():
    """inject_failure re-queues in-flight work, which still finishes;
    snapshot/restore carries the fitted model and the queue."""
    arch, cluster = _cluster()
    rng = np.random.default_rng(1)
    reqs = [_mk_req(rng, arch) for _ in range(6)]
    for r in reqs:
        cluster.submit(r)
    cluster.heartbeat()
    victim = next(iter(cluster.workers))
    assert cluster.inject_failure(victim) > 0
    assert victim not in cluster.workers
    cluster.run_until_drained(max_beats=300)
    assert all(r.state == ReqState.FINISHED for r in reqs)
    late = [_mk_req(rng, arch) for _ in range(2)]
    for r in late:                   # queued, not yet placed
        cluster.submit(r)
    snap = cluster.snapshot()
    _, fresh = _cluster(n_workers=1)
    fresh.restore(snap)
    assert fresh.perf.decode == cluster.perf.decode
    assert fresh.perf.prefill == cluster.perf.prefill
    assert [(r.l_in, r.l_pred, r.l_real) for r in fresh.queued] == \
        [(r.l_in, r.l_pred, r.l_real) for r in late]
    assert len(fresh.workers) == snap["n_workers"] == len(cluster.workers)


class _Clock:
    """Deterministic counter clock with uneven steps, so the TraceBuffer
    sees varied iteration 'times' and the Eq. 2/3 fits are not trivial."""

    def __init__(self):
        self.n = 0
        self.t = 0.0

    def __call__(self) -> float:
        self.n += 1
        self.t += 0.01 + 0.003 * (self.n % 7) + 0.001 * (self.n % 3)
        return self.t


def _run_lockstep(cluster, make_req, specs, fail_beat):
    """Submit one request per heartbeat, then drain; return per-request
    outcome keyed by submission index, and the finish beat of each."""
    reqs = []
    finish_beat = {}
    beat = 0

    def hb():
        nonlocal beat
        for r in cluster.heartbeat():
            finish_beat[reqs.index(r)] = beat
        beat += 1

    for l_in, l_real, toks, session in specs:
        r = make_req(l_in=l_in, l_pred=0, l_real=l_real, arrival=0.0)
        r.tokens = list(toks)
        r.session_id = session
        reqs.append(r)
        cluster.submit(r)
        hb()
        if beat == fail_beat:
            cluster.inject_failure(next(iter(cluster.workers)))
    for _ in range(300):
        if not cluster.queued and all(
                not w.state.ongoing and not w.engine.waiting
                and not w.state.new_batch for w in cluster.workers.values()):
            break
        hb()
    return ([(r.worker, r.tokens, r.t_first_token, r.t_finish, r.l_out)
             for r in reqs], finish_beat, reqs)


@pytest.mark.parametrize("policy,router,fail_beat,chunk", [
    pytest.param("aladdin", "blind", -1, 0, id="aladdin-blind--1"),
    pytest.param("jsq", "blind", -1, 0, id="jsq-blind--1"),
    pytest.param("aladdin", "blind", 4, 0, id="aladdin-blind-4"),
    pytest.param("aladdin", "sticky", -1, 0, id="aladdin-sticky--1"),
    # Sarathi-style chunked prefill, 8 tokens an iteration: prompts of 6-40
    # take up to 5 chunks, each attending to its context pages
    pytest.param("aladdin", "blind", -1, 8, id="aladdin-blind--1-chunk8"),
])
def test_cluster_lockstep_with_jax(policy, router, fail_beat, chunk):
    kw = dict(n_layers=2, d_model=48, vocab=96)
    ja = dataclasses.replace(jax_reduced(jax_get_arch("llama2-7b"), **kw),
                             param_dtype="float32")
    ta = dataclasses.replace(reduced(get_arch("llama2-7b"), **kw),
                             param_dtype="float32")
    jp = JaxLM(ja).init(jax.random.key(0))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    specs = []
    for i in range(10):
        l_in = int(rng.integers(6, 40))
        specs.append((l_in, int(rng.integers(3, 10)),
                      [int(x) for x in rng.integers(2, ja.vocab, l_in)],
                      i % 3 if router == "sticky" else -1))
    slo = dict(ttft=0.5, atgt=0.05)
    engine_kw = dict(ENGINE_KW, prefill_chunk=chunk)
    jc = jax_cluster.ServingCluster(
        ja, jp, JaxSLO(**slo), engine_cfg=JaxEngineConfig(**engine_kw),
        cfg=jax_cluster.ClusterConfig(policy=policy, router=router),
        n_workers=2, time_fn=_Clock())
    tc = ServingCluster(
        ta, tp, SLO(**slo), engine_cfg=EngineConfig(**engine_kw),
        cfg=ClusterConfig(policy=policy, router=router), n_workers=2,
        time_fn=_Clock(), device="cpu")
    # the port seeds placement with H100 figures, the reference with TPU
    # v5e ones; start both from the reference's seed (the workers' states
    # share the cluster's PerfModel object, so this reaches them too)
    seed = analytic_perf_model(ta)
    for part in ("kv", "prefill", "decode"):
        setattr(tc.perf, part, getattr(seed, part))
    want, want_beats, jreqs = _run_lockstep(jc, JaxRequest, specs, fail_beat)
    got, got_beats, treqs = _run_lockstep(tc, Request, specs, fail_beat)
    assert all(r.state == JaxReqState.FINISHED for r in jreqs)
    assert all(r.state == ReqState.FINISHED for r in treqs)
    assert got == want
    assert got_beats == want_beats
    assert tc.failed_events == jc.failed_events
    assert sorted(tc.workers) == sorted(jc.workers)
    assert tc.attainment() == jc.attainment()
    for part in ("prefill", "decode", "kv"):
        a, b = getattr(tc.perf, part), getattr(jc.perf, part)
        for f in dataclasses.fields(a):
            np.testing.assert_allclose(getattr(a, f.name), getattr(b, f.name),
                                       rtol=1e-9, atol=0)
    assert tc.perf.max_rel_err.keys() == jc.perf.max_rel_err.keys()
    assert tc.perf.decode.k2 != 0.0
