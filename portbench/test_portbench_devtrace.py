"""Reading a device trace (no card needed): the markers tie the device's
clock to the host's, busy time is the union of the operations, idle gaps
are charged to the host span the host was in."""
import pytest

pytest.importorskip("torch")

from pbcore import devtrace  # noqa: E402
from pbcore.serve import Step  # noqa: E402


def _trace():
    # device microseconds = host seconds * 1e6 + 5000; markers at the ends
    off = 5000.0
    ops = [("marker", 1e6 + off, 10.0),
           ("gemm", 1e6 + off + 100, 200.0),        # 1.0001-1.0003
           ("paged_decode_kernel_split", 1e6 + off + 250, 100.0),
           ("paged_decode_kernel_merge", 1e6 + off + 300, 100.0),
           ("gemm", 1e6 + off + 1000, 500.0),       # 1.001-1.0015
           ("marker", 1e6 + off + 2000, 10.0)]
    return devtrace.Trace.from_ops(ops, 1.0, 1.002)


def test_clock_and_busy():
    tr = _trace()
    assert tr.window == pytest.approx((1.00001, 1.002))
    assert tr.skew == pytest.approx(0.0)
    assert len(tr.ops) == 4
    # gemm 100-300 and the decode pair 250-400 overlap: 100-400, 1000-1500
    assert tr.busy_s() == pytest.approx(800e-6)
    assert tr.busy_s(["paged_decode_kernel"]) == pytest.approx(150e-6)
    assert tr.count("paged_decode_kernel_split") == 1
    assert tr.top_ops(1) == [["gemm", pytest.approx(700e-6)]]
    gaps = tr.gaps()
    assert gaps[0] == pytest.approx((1.00001, 1.0001))
    assert sum(b - a for a, b in gaps) == pytest.approx(
        tr.window_s - 800e-6)


def test_idle_gaps_by_host_span():
    tr = _trace()
    steps = [Step(1, 1.0, 1.0004, "decode"), Step(2, 1.0009, 1.0016,
                                                 "prefill")]
    beats = [(0.9999, 1.0017)]
    got = dict(map(tuple, devtrace.idle_by_host_span(tr, steps, beats)))
    assert got["engine.step.decode"] == pytest.approx(90e-6)
    assert got["cluster.heartbeat (outside engine steps)"] == \
        pytest.approx(600e-6)
    assert got["harness loop (submit, sleep, observe)"] == \
        pytest.approx(500e-6)
