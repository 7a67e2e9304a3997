"""The serving loop's spans (``repro_torch.serving.spans``) on the CPU: a
reduced two-worker cluster serves a stream under a counter clock, and its
records nest as the sites promise; the ring keeps its bound; with the
recorder off nothing is recorded and the same tokens are served."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.cluster import (ClusterConfig,  # noqa: E402
                                         ServingCluster)
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.spans import RECORDER, SpanRecorder  # noqa: E402

N_WORKERS = 2


class _Clock:
    """The cluster's and engines' clock: a counter, so that the fits and
    hence the placements repeat exactly between runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.01
        return self.t


def _serve(n_req=8, seed=0):
    """Submit a request a heartbeat, then drain. Returns the requests and
    the records made meanwhile."""
    arch = reduced(get_arch("llama2-7b"), n_layers=2, d_model=48, vocab=96)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    cluster = ServingCluster(
        arch, params, SLO(ttft=30.0, atgt=5.0),
        engine_cfg=EngineConfig(max_batch=4, page_size=8, n_pages=96,
                                max_pages_per_seq=8),
        cfg=ClusterConfig(heartbeat_iters=2), n_workers=N_WORKERS,
        time_fn=_Clock(), device="cpu")
    rng = np.random.default_rng(seed)
    n0 = RECORDER.recorded
    reqs = []
    for _ in range(n_req):
        r = Request(l_in=int(rng.integers(6, 24)), l_pred=0,
                    l_real=int(rng.integers(3, 8)), arrival=0.0)
        r.tokens = [int(x) for x in rng.integers(2, arch.vocab, r.l_in)]
        cluster.submit(r)
        reqs.append(r)
        cluster.heartbeat()
    cluster.run_until_drained(max_beats=300)
    assert all(r.l_out == r.l_real for r in reqs)
    return reqs, [s for s in RECORDER.spans() if s.index >= n0]


@pytest.fixture(scope="module")
def served():
    assert RECORDER.enabled
    return _serve()


def _children(spans):
    out = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def test_spans_nest_under_their_causes(served):
    _, spans = served
    by = {s.index: s for s in spans}
    kids = _children(spans)
    assert all(s.t0 <= s.t1 for s in spans)
    steps = [s for s in spans if s.name == "engine.step"]
    decode = prefill = 0
    for st in steps:
        assert by[st.parent].name == "cluster.heartbeat"
        names = [c.name for c in kids.get(st.index, [])]
        if "engine.prefill" in names:
            prefill += 1
            assert set(names) == {"engine.prefill"}
        elif names:
            decode += 1
            assert names == ["engine.decode.launch", "engine.decode.wait"]
            launch, wait = kids[st.index]
            assert st.t0 <= launch.t0 <= launch.t1 <= wait.t0 <= wait.t1 \
                <= st.t1
        for c in kids.get(st.index, []):
            assert not kids.get(c.index), "nothing opens inside a leaf"
    assert decode > 0 and prefill > 0


def test_each_request_is_submitted_placed_then_prefilled(served):
    reqs, spans = served
    by = {s.index: s for s in spans}
    first = {}
    for s in spans:
        first.setdefault((s.name, s.rid), s)
    for r in reqs:
        sub = first[("request.submit", r.id)]
        placed = first[("request.placed", r.id)]
        pre = first[("engine.prefill", r.id)]
        assert sub.t0 == sub.t1 and placed.t0 == placed.t1
        assert sub.t0 <= placed.t0 <= pre.t0
        assert sub.parent == -1
        assert by[placed.parent].name == "cluster.place"
        assert by[pre.parent].name == "engine.step"
    assert {s.rid for s in spans if s.name.startswith("cluster.")} == {-1}


def test_one_refit_a_worker_a_beat(served):
    _, spans = served
    kids = _children(spans)
    beats = [s for s in spans if s.name == "cluster.heartbeat"]
    assert beats and all(s.parent == -1 for s in beats)
    for b in beats:
        names = [c.name for c in kids[b.index]]
        assert names.count("cluster.refit") == N_WORKERS
        assert names[:2] == ["cluster.place", "cluster.rebalance"]
        assert names.count("cluster.place") == 1
        assert names.count("cluster.rebalance") == 1
        inner = [c for c in kids[b.index] if c.name != "engine.step"]
        assert all(b.t0 <= c.t0 <= c.t1 <= b.t1 for c in inner)


def test_the_ring_keeps_its_bound_and_counts_what_it_dropped():
    rec = SpanRecorder(capacity=8)
    outer = rec.begin("outer", 7)
    for k in range(20):
        rec.end(rec.begin(f"s{k}"))
    rec.end(outer)                         # overwritten: no record to close
    rec.instant("last", 3)
    assert rec.recorded == 22 and rec.dropped == 14
    got = rec.spans()
    assert len(got) == 8
    assert [s.index for s in got] == list(range(14, 22))
    assert [s.name for s in got] == [f"s{k}" for k in range(13, 20)] \
        + ["last"]
    assert all(s.parent == 0 for s in got[:-1])
    assert got[-1].parent == -1 and got[-1].rid == 3
    assert got[-1].t0 == got[-1].t1


def test_an_exception_closes_the_spans_it_left_open():
    rec = SpanRecorder()

    @rec.traced("outer")
    def fail():
        rec.begin("inner")
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError):
        fail()
    rec.instant("after")
    outer, inner, after = rec.spans()
    assert not math.isnan(outer.t1) and math.isnan(inner.t1)
    assert inner.parent == outer.index and after.parent == -1


def test_disabled_records_nothing_and_serves_the_same_tokens(served):
    reqs_on, _ = served
    RECORDER.enabled = False
    try:
        n0 = RECORDER.recorded
        reqs_off, spans = _serve()
        assert spans == [] and RECORDER.recorded == n0
    finally:
        RECORDER.enabled = True
    assert [r.tokens for r in reqs_off] == [r.tokens for r in reqs_on]
    assert [r.tokens for r in reqs_on] == [r.tokens for r in _serve()[0]]
