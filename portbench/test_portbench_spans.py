"""The readers of the program's own spans (``pbcore.progspans``): a tiny
cell run on the CPU, traced and untraced, yields every one of them, with
a stand-in for the device trace; and on synthetic spans and a synthetic
``devtrace.Trace`` each gives the value worked out by hand."""
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from pbcore import devtrace, harness, progspans, tiny  # noqa: E402
from pbcore.serve import Served  # noqa: E402
from pbcore.spec import Bench  # noqa: E402
from repro_torch.serving.spans import (RECORDER, Span,  # noqa: E402
                                       SpanRecorder)

HOST = ["decode_launch_ms.chat", "decode_wait_ms.chat",
        "refit_ms_per_beat.chat", "schedule_ms_per_beat.chat",
        "place_wait_ms.docqa", "prefill_wait_ms.docqa"]
DEVICE = ["decode_ops_per_step.chat", "launch_idle_share.chat"]
DTOH = "Memcpy DtoH (Device -> Pageable)"


class _CpuSpan:
    """``devtrace.Span`` on the CPU: the host window it was open, and a
    device trace a card could show, made from the program's own records:
    one operation over the second half of each decode launch, the
    device-to-host copy over each wait and at the end of each prefill,
    between the two markers."""

    def __init__(self, clock):
        self.clock = clock
        self.h0 = self.h1 = None

    @staticmethod
    def warm():
        pass

    def start(self):
        self.h0 = self.clock()

    def stop(self):
        self.h1 = self.clock()

    def read(self):
        us = 1e6
        ops = []
        for s in RECORDER.spans():
            if self.h0 < s.t0 and s.t1 < self.h1:
                if s.name == "engine.decode.launch":
                    mid = (s.t0 + s.t1) / 2
                    ops.append(("gemm", mid * us, (s.t1 - mid) * us))
                elif s.name == "engine.decode.wait":
                    ops.append((DTOH, s.t0 * us, (s.t1 - s.t0) * us))
                elif s.name == "engine.prefill":
                    ops.append((DTOH, s.t1 * us - 1.0, 1.0))
        ops = [("marker", self.h0 * us, 1.0)] + ops \
            + [("marker", self.h1 * us, 1.0)]
        return devtrace.Trace.from_ops(ops, self.h0, self.h1)


def _tiny_run(tmp_path, monkeypatch, trace):
    """One run of a tiny cell that reports the new metrics beside
    ``decode_iter_ms.chat`` and ``idle_share.chat``; returns the result
    and the readers' ``Obs``."""
    monkeypatch.setattr(devtrace, "Span", _CpuSpan)
    seen = {}
    read = harness.read_metrics

    def keep(bench, cell, o, trace, device_info):
        seen["o"] = o
        return read(bench, cell, o, trace, device_info)
    monkeypatch.setattr(harness, "read_metrics", keep)
    # a 2 s span, so that a loaded CPU still runs decode steps inside it
    wl = dict(tiny.workload("t-cfg", "t-mix"), trace_s=2.0)
    bench = tiny.bench(tmp_path, "t.cell", tiny.config(), wl)
    for m in bench.bench["per_layer"]:
        if m["name"] in HOST + DEVICE + ["decode_iter_ms.chat",
                                         "idle_share.chat"]:
            m["workloads"].append("t.cell")
    out = harness.run_cell(bench, bench.cell("t.cell"), 3, 4.0, trace,
                           "cpu", time.perf_counter())
    return out, seen["o"]


def test_a_tiny_cell_yields_every_new_metric(tmp_path, monkeypatch):
    out, o = _tiny_run(tmp_path / "traced", monkeypatch, True)
    assert out["correct"] is True
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(HOST + DEVICE) <= set(got)
    assert got["decode_launch_ms.chat"] > 0
    assert got["refit_ms_per_beat.chat"] > 0
    assert got["decode_launch_ms.chat"] + got["decode_wait_ms.chat"] \
        <= got["decode_iter_ms.chat"]
    assert got["decode_ops_per_step.chat"] == 2.0
    assert 0 < got["launch_idle_share.chat"] <= got["idle_share.chat"]
    assert all(got[k] >= 0 for k in HOST)

    out, o = _tiny_run(tmp_path / "untraced", monkeypatch, False)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"ttft_p50_s", "atgt_p90_ms", "setup_s"}
    bench = Bench()
    for name in HOST:
        assert bench.reader(name).read(o) is not None, name
    for name in DEVICE:
        assert bench.reader(name).read(o) is None, name


def _obs(trace=None, t0=0.9, t_end=1.2, t_drained=1.3):
    served = Served(t0=t0, t_end=t_end, t_drained=t_drained, requests=[],
                    beats=[], tokens_at_close=0)
    return harness.Obs(cell=None, cfg=None, seconds=t_end - t0, setup_s=0.0,
                       served=served, observer=None, slo=None, trace=trace)


def _spans(rows):
    """Span records from (name, t0, t1, parent, rid) rows, indexed in
    order."""
    return [Span(i, *r) for i, r in enumerate(rows)]


def _read(monkeypatch, rows, o, name):
    monkeypatch.setattr(progspans, "records", lambda _: _spans(rows))
    return Bench().reader(name).read(o)


# a traced window 1.0-1.2 s on the host's clock; two decode steps inside
# it (A: 3 of its operations start inside [launch start, wait end], then a
# memset after it; B: 2), one whose launch began 10 ms before the window
# (not a step of the span, but its launch's idle time inside the window
# counts), and one just after it. Each step ends in its copy to the host.
TRACED = [("engine.step", 0.98, 1.018, -1, -1),
          ("engine.decode.launch", 0.99, 1.01, 0, -1),
          ("engine.decode.wait", 1.01, 1.016, 0, -1),
          ("engine.step", 1.02, 1.1, -1, -1),
          ("engine.decode.launch", 1.024, 1.08, 3, -1),
          ("engine.decode.wait", 1.08, 1.098, 3, -1),
          ("engine.step", 1.12, 1.19, -1, -1),
          ("engine.decode.launch", 1.124, 1.17, 6, -1),
          ("engine.decode.wait", 1.17, 1.188, 6, -1),
          ("engine.decode.launch", 0.8, 0.9, -1, -1),
          ("engine.step", 1.2, 1.224, -1, -1),
          ("engine.decode.launch", 1.202, 1.216, 10, -1),
          ("engine.decode.wait", 1.216, 1.222, 10, -1)]
OPS = [(DTOH, 1.012, 1.016), ("gemm", 1.04, 1.05),
       ("gemm", 1.06, 1.09), (DTOH, 1.092, 1.098),
       ("Memset (Device)", 1.1, 1.104), ("gemm", 1.14, 1.16),
       (DTOH, 1.174, 1.188), (DTOH, 1.218, 1.222)]


def _mapped(ops, window, off=0.0, rate=0.0):
    """A trace whose clock runs ``off`` s ahead of the host's at 1.0 s and
    ``rate`` faster, as the markers may leave it: the window opens on the
    host's clock and closes on the trace's."""
    def g(t):
        return t + off + rate * (t - 1.0)
    return devtrace.Trace([(n, g(a), g(b)) for n, a, b in ops],
                          (window[0], g(window[1])), 0.0)


@pytest.mark.parametrize("off,rate", [(0.0, 0.0), (0.002, 1e-3),
                                      (-0.003, -2e-4), (-0.03, 5e-3)])
def test_device_readings_by_hand(monkeypatch, off, rate):
    o = _obs(_mapped(OPS, (1.0, 1.2), off, rate))
    assert _read(monkeypatch, TRACED, o, "decode_ops_per_step.chat") == \
        pytest.approx((3 + 2) / 2)
    # idle inside launches: A 56 ms less busy 10 + 20; B 46 less 20; the
    # early launch's 10 ms inside the window, all idle
    assert _read(monkeypatch, TRACED, o, "launch_idle_share.chat") == \
        pytest.approx(100 * (26e-3 + 26e-3 + 10e-3) / 0.2)
    tr, pairs = progspans.aligned(o, _spans(TRACED))
    assert tr.window == pytest.approx((1.0, 1.2), abs=1e-9)
    assert pairs[:, 1] == pytest.approx([1.016, 1.098, 1.188, 1.222])
    assert _read(monkeypatch, TRACED, _obs(), "launch_idle_share.chat") \
        is None
    # no copy to tie the clocks by: nothing is read
    bare = _obs(_mapped([x for x in OPS if x[0] != DTOH], (1.0, 1.2)))
    assert _read(monkeypatch, TRACED, bare, "decode_ops_per_step.chat") \
        is None


HOSTLY = [("cluster.heartbeat", 1.00, 1.01, -1, -1),          # 0
          ("cluster.place", 1.000, 1.001, 0, -1),
          ("cluster.rebalance", 1.001, 1.0015, 0, -1),
          ("cluster.refit", 1.008, 1.0085, 0, -1),
          ("cluster.refit", 1.009, 1.0092, 0, -1),
          ("cluster.heartbeat", 1.02, 1.03, -1, -1),          # 5
          ("cluster.place", 1.020, 1.0205, 5, -1),
          ("cluster.refit", 1.028, 1.029, 5, -1),
          ("cluster.refit", 1.029, 1.0291, 5, -1),
          ("cluster.heartbeat", 1.5, 1.51, -1, -1),           # 9: after
          ("cluster.refit", 1.50, 1.505, 9, -1),
          ("engine.step", 1.04, 1.05, -1, -1),                # 11
          ("engine.decode.launch", 1.041, 1.047, 11, -1),
          ("engine.decode.wait", 1.047, 1.049, 11, -1),
          ("engine.step", 1.06, 1.07, -1, -1),                # 14
          ("engine.decode.launch", 1.060, 1.064, 14, -1),
          ("engine.decode.wait", 1.064, 1.065, 14, -1),
          ("request.submit", 0.5, 0.5, -1, 4),                # before
          ("request.placed", 0.6, 0.6, -1, 4),
          ("request.submit", 1.0, 1.0, -1, 1),
          ("request.placed", 1.002, 1.002, -1, 1),
          ("engine.prefill", 1.005, 1.01, -1, 1),
          ("request.submit", 1.1, 1.1, -1, 2),                # no prefill
          ("request.placed", 1.1001, 1.1001, -1, 2),
          ("request.submit", 1.15, 1.15, -1, 3)]              # unplaced


def test_host_readings_by_hand(monkeypatch):
    o = _obs()
    want = {"refit_ms_per_beat.chat": (0.5 + 0.2 + 1.0 + 0.1) / 2,
            "schedule_ms_per_beat.chat": (1.0 + 0.5 + 0.5) / 2,
            "decode_launch_ms.chat": (6.0 + 4.0) / 2,
            "decode_wait_ms.chat": (2.0 + 1.0) / 2,
            # submit -> placed 2, 0.1, 150 (to the drain's end) ms
            "place_wait_ms.docqa": 2.0,
            # placed -> prefill 3, 199.9 (the drain's end), 0 ms
            "prefill_wait_ms.docqa": 3.0}
    for name, value in want.items():
        assert _read(monkeypatch, HOSTLY, o, name) == pytest.approx(value), \
            name
    # the traced span 1.03-1.065 hides the second heartbeat and both steps
    traced = _obs(devtrace.Trace(OPS, (1.03, 1.065), 0.0))
    assert _read(monkeypatch, HOSTLY, traced, "refit_ms_per_beat.chat") == \
        pytest.approx(0.7)
    assert _read(monkeypatch, HOSTLY, traced, "decode_launch_ms.chat") is None


def test_nothing_to_read_is_none(monkeypatch):
    o = _obs(t0=0.0)
    rec = SpanRecorder(capacity=4)
    for _ in range(10):
        rec.instant("request.submit", 1)
    monkeypatch.setattr("repro_torch.serving.spans.RECORDER", rec)
    # records dropped, the oldest kept one begun after the window opened
    assert progspans.records(o) is None
    assert Bench().reader("place_wait_ms.docqa").read(o) is None
    # dropped before the window opened: the kept records are read
    assert len(progspans.records(_obs(t0=time.perf_counter() + 1))) == 4
    # a program that records no spans (the parent commit)
    monkeypatch.setitem(sys.modules, "repro_torch.serving.spans", None)
    assert progspans.records(o) is None
    assert Bench().reader("refit_ms_per_beat.chat").read(o) is None
