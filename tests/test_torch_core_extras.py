"""The port's copies of the reference's Appendix A scheduler
(``core/distributed_scheduler.py``) and exact placement oracle
(``core/mip.py``): twins of the reference's tests that use them
(tests/test_scheduler_extras.py, tests/test_extras.py,
tests/test_placement.py, tests/test_placement_properties.py), with every
name imported from ``repro_torch.core``; and the straggler drain of the
port's live ``ServingCluster``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core import (SLO, DecodeModel, GroupedScheduler,  # noqa: E402
                              KVModel, PerfModel, PlacementConfig,
                              PrefillModel, Request, SchedLatencyModel,
                              WorkerState, best_fit_place,
                              choose_group_count, exact_min_workers)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.cluster import (ClusterConfig,  # noqa: E402
                                         ServingCluster)
from repro_torch.serving.engine import EngineConfig  # noqa: E402


def _perf(k1=1e-4, c1=1e-3, k2=1e-6, c2=1e-4, c3=5e-3):
    return PerfModel(kv=KVModel(1.0, 0.0), prefill=PrefillModel(k1, c1),
                     decode=DecodeModel(k2, c2, c3))


def test_grouped_scheduler_round_robin_and_placement():
    perf = _perf()
    workers = [WorkerState(i, PlacementConfig(kv_capacity=1e7, max_batch=64),
                           perf, SLO(5.0, 0.5)) for i in range(8)]
    sched = GroupedScheduler(workers, n_groups=4)
    assert all(len(g) == 2 for g in sched.groups)
    placed = [sched.place(Request(l_in=64, l_pred=64)) for _ in range(16)]
    assert all(w is not None for w in placed)
    # round-robin: each group received 4 requests
    per_group = [sum(len(w.new_batch) + len(w.ongoing) for w in g)
                 for g in sched.groups]
    assert per_group == [4, 4, 4, 4]


def test_choose_group_count_bounds():
    lat = SchedLatencyModel(a=2e-6, b=1e-4)
    g = choose_group_count(rate=1000.0, n_workers=64, error_budget=0.1,
                           t_s=0.01, heartbeat=0.25, lat=lat)
    assert 1 <= g <= 64
    # tighter latency target -> at least as many groups
    g2 = choose_group_count(rate=1000.0, n_workers=64, error_budget=0.1,
                            t_s=0.002, heartbeat=0.25, lat=lat)
    assert g2 >= g


def test_sched_latency_model_fit_and_invert():
    m = SchedLatencyModel(a=1e-6, b=1e-4)
    ns = [10, 100, 1000]
    f = SchedLatencyModel.fit(ns, [m(n) for n in ns])
    assert abs(f.a - 1e-6) < 1e-7
    r = f.max_rate(t_s=0.05, heartbeat=0.25)
    assert f(r * 0.25) <= 0.0501


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_heuristic_near_optimal_vs_mip(seed):
    """Best-fit stays within +1 worker of the exact MIP optimum."""
    rng = np.random.default_rng(seed)
    perf = PerfModel(kv=KVModel(1.0, 0.0), prefill=PrefillModel(1e-4, 5e-3),
                     decode=DecodeModel(1e-9, 1e-9, 5e-3))

    def mk(i):
        cfg = PlacementConfig(gamma=1.0, theta=1.0, kv_capacity=2000.0,
                              max_batch=6)
        return WorkerState(i, cfg, perf, SLO(1e9, 1e9))

    reqs = [Request(l_in=int(rng.integers(100, 900)),
                    l_pred=int(rng.integers(50, 400))) for _ in range(9)]
    opt = exact_min_workers([Request(l_in=r.l_in, l_pred=r.l_pred)
                             for r in reqs], mk, max_workers=9)
    assert opt is not None
    workers = []
    n = [100]

    def factory():
        n[0] += 1
        return mk(n[0])
    for r in reqs:
        assert best_fit_place(workers, r, new_worker_factory=factory)
    assert len(workers) <= opt + 1


def test_best_fit_within_mip_oracle_bound():
    """On small instances best-fit stays within 2x the exact MIP minimum."""
    rng = np.random.default_rng(4)
    perf = _perf(c1=5e-3, c2=1e-3)
    slo = SLO(ttft=2.0, atgt=0.05)
    checked = 0
    for _ in range(15):
        cfg = PlacementConfig(gamma=0.5, theta=1.0,
                              kv_capacity=float(rng.uniform(2e3, 2e4)),
                              max_batch=4)

        def factory(i=0):
            return WorkerState(i, cfg, perf, slo)

        reqs = [Request(l_in=int(rng.integers(16, 1024)),
                        l_pred=int(rng.integers(16, 1024)))
                for _ in range(int(rng.integers(3, 7)))]
        opt = exact_min_workers([Request(l_in=r.l_in, l_pred=r.l_pred)
                                 for r in reqs], factory, max_workers=6)
        if opt is None:
            continue
        workers = []
        n = [0]

        def bf_factory():
            n[0] += 1
            return WorkerState(100 + n[0], cfg, perf, slo)

        for r in reqs:
            assert best_fit_place(workers, r,
                                  new_worker_factory=bf_factory) is not None
        checked += 1
        assert opt <= len(workers) <= 2 * opt, (len(workers), opt)
    assert checked >= 5


def test_straggler_detection_drains():
    arch = reduced(get_arch("llama2-7b"), n_layers=2, d_model=32, vocab=64)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    cluster = ServingCluster(
        arch, params, SLO(ttft=30.0, atgt=5.0),
        engine_cfg=EngineConfig(max_batch=4, page_size=8, n_pages=64,
                                max_pages_per_seq=8),
        cfg=ClusterConfig(min_workers=1, max_workers=4), n_workers=4,
        device="cpu")
    ids = list(cluster.workers)
    for wid in ids[:3]:
        cluster.workers[wid].iter_ema = 0.01
    cluster.workers[ids[3]].iter_ema = 10.0     # pathological straggler
    out = cluster._detect_stragglers()
    assert ids[3] in out
    assert cluster.workers[ids[3]].state.draining
