"""The device trace of a span of the window, from ``torch.profiler``
(CUPTI, device activity only, so that the host's own operators add no
events), and what is read from it.

The span starts and stops between heartbeats, where the device is idle
(every engine step ends in a host read). A marker kernel
(``torch.cuda._sleep``) launched right after each clock read on the host
ties the device's timeline to the host clock: device time = host time +
the first marker's offset. The trace is written as Chrome JSON to a
temporary file, read back and deleted.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_CYCLES = 20_000


class Span:
    """Start with ``start()`` and end with ``stop()``, both at a moment the
    device is idle. ``warm()`` (in set-up) starts and stops the profiler
    once, so that the first start inside the window does not pay CUPTI's
    initialisation."""

    def __init__(self, clock):
        self.clock = clock
        self.prof = None
        self.h0 = self.h1 = None

    @staticmethod
    def warm() -> None:
        import torch
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.h0 = self.clock()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        """End the span; its trace is read later (``read``), once the
        window has closed, so that the reading does not stall serving."""
        import torch
        torch.cuda.synchronize()
        self.h1 = self.clock()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        ops = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                      for e in events if e.get("cat") in DEVICE_CATS
                      and "ts" in e), key=lambda o: o[1])
        return Trace.from_ops(ops, self.h0, self.h1)


class Trace:
    """Device operations in host seconds, inside the traced window."""

    def __init__(self, ops, window, skew):
        self.ops: List[Tuple[str, float, float]] = ops   # name, start, end
        self.window = window                             # host (t0, t1)
        self.skew = skew        # second marker's offset less the first's, s

    @classmethod
    def from_ops(cls, ops, h0, h1):
        if len(ops) < 2:
            return cls([], (h0, h1), None)
        m0, m1 = ops[0], ops[-1]
        off = m0[1] * 1e-6 - h0          # device seconds = host + off
        skew = (m1[1] * 1e-6 - h1) - off
        w0 = (m0[1] + m0[2]) * 1e-6 - off
        w1 = m1[1] * 1e-6 - off
        inner = [(n, ts * 1e-6 - off, (ts + d) * 1e-6 - off)
                 for n, ts, d in ops[1:-1]]
        return cls(inner, (w0, w1), skew)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, names: Optional[Sequence[str]] = None
             ) -> List[Tuple[float, float]]:
        """Union of the intervals of the operations whose names hold one
        of ``names`` (all, by default), clipped to the window."""
        ivs = sorted((max(a, self.window[0]), min(b, self.window[1]))
                     for n, a, b in self.ops
                     if names is None or any(s in n for s in names))
        out: List[List[float]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, names: Optional[Sequence[str]] = None) -> float:
        return sum(b - a for a, b in self.busy(names))

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.ops if name in n)

    def top_ops(self, k: int = 10, width: int = 160) -> List[list]:
        """The ``k`` operations that took most device time, by name (cut
        to ``width`` characters), with their seconds."""
        tot: Dict[str, float] = {}
        for n, a, b in self.ops:
            n = n[:width]
            tot[n] = tot.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's idle intervals."""
        out, t = [], self.window[0]
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out


def idle_by_host_span(trace: Trace, steps, beats, k: int = 10) -> List[list]:
    """Idle device seconds summed by what the host was in at each gap's
    midpoint: an engine step (by kind), a heartbeat outside its engine
    steps (the control plane), or the harness's loop (submitting,
    sleeping to the next arrival)."""
    st = sorted((s.t0, s.t1, f"engine.step.{s.kind}") for s in steps)
    bt = sorted(beats)
    st0 = [s[0] for s in st]
    bt0 = [b[0] for b in bt]

    def where(t):
        i = bisect.bisect_right(st0, t) - 1
        if i >= 0 and st[i][1] >= t:
            return st[i][2]
        j = bisect.bisect_right(bt0, t) - 1
        if j >= 0 and bt[j][1] >= t:
            return "cluster.heartbeat (outside engine steps)"
        return "harness loop (submit, sleep, observe)"
    tot: Dict[str, float] = {}
    for a, b in trace.gaps():
        key = where((a + b) / 2)
        tot[key] = tot.get(key, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(tot.items(),
                                      key=lambda kv: -kv[1])[:k]]
