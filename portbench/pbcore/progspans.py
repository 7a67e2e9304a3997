"""The program's own spans (``repro_torch.serving.spans.RECORDER``), as the
per-layer metrics of the serving loop read them.

Program spans share the host clock (``perf_counter``) with the harness's
window. Host times are read over the window less the traced span
(``Obs._untraced``), as the harness's own host metrics are; device
readings over the traced span, its trace mapped onto the program's clock
by ``aligned``. A program that records no spans gives nothing to read,
and neither does a ring that may have dropped a record begun after the
window opened: each function then returns None, says why on standard
error, and the metric is left out.
"""
from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pbcore import devtrace, readings


def _log(msg: str) -> None:
    print(f"[spans] {msg}", file=sys.stderr, flush=True)


def records(o) -> Optional[list]:
    """Every kept record, or None. The ring drops its oldest records
    first, so none begun after the window opened is lost while the oldest
    kept one began before it."""
    try:
        from repro_torch.serving.spans import RECORDER
    except ImportError:
        _log("the program records no spans")
        return None
    spans = RECORDER.spans()
    if RECORDER.dropped and (not spans or spans[0].t0 >= o.served.t0):
        _log(f"the ring dropped {RECORDER.dropped} records, the oldest kept "
             f"one begun after the window opened")
        return None
    return spans


def in_window(o, spans, name: str) -> list:
    """Spans of ``name`` that ended inside the window, outside the traced
    span."""
    s = o.served
    return [x for x in spans if x.name == name and s.t0 <= x.t1 <= s.t_end
            and o._untraced(x.t0, x.t1)]


def decode_steps(spans) -> Dict[int, Tuple]:
    """{engine.step index: (launch span, wait span)} of the decode steps."""
    launch = {x.parent: x for x in spans
              if x.name == "engine.decode.launch"}
    return {x.parent: (launch[x.parent], x) for x in spans
            if x.name == "engine.decode.wait" and x.parent in launch}


def decode_part_ms(o, part: int) -> Optional[float]:
    """Mean host ms of a decode step's launch (``part`` 0) or wait (1),
    over the decode steps that ended inside the window."""
    spans = records(o)
    if spans is None:
        return None
    kept = {x.index for x in in_window(o, spans, "engine.step")}
    d = [pair[part].t1 - pair[part].t0
         for k, pair in decode_steps(spans).items() if k in kept]
    return 1e3 * sum(d) / len(d) if d else None


def per_beat_ms(o, names: Sequence[str]) -> Optional[float]:
    """Host ms of the spans ``names`` directly inside the window's
    heartbeats, over those heartbeats."""
    spans = records(o)
    if spans is None:
        return None
    beats = {x.index for x in in_window(o, spans, "cluster.heartbeat")}
    if not beats:
        return None
    total = sum(x.t1 - x.t0 for x in spans
                if x.name in names and x.parent in beats)
    return 1e3 * total / len(beats)


def request_times(o, spans) -> List[Tuple[float, float, float]]:
    """(submitted, first placed, first prefill start) of each request
    submitted inside the window, outside the traced span; a request never
    placed or prefilled counts to the end of the drain."""
    first: Dict[tuple, float] = {}
    for x in spans:
        if x.rid >= 0:
            first.setdefault((x.name, x.rid), x.t0)
    end = o.served.t_drained
    return [(x.t0, first.get(("request.placed", x.rid), end),
             first.get(("engine.prefill", x.rid), end))
            for x in in_window(o, spans, "request.submit")]


def median_wait_ms(o, a: int, b: int) -> Optional[float]:
    """Median ms from a request's time ``a`` to its time ``b`` (indices
    into ``request_times``' triples)."""
    spans = records(o)
    if spans is None:
        return None
    p50 = readings.percentile([t[b] - t[a] for t in request_times(o, spans)],
                              50)
    return None if p50 is None else 1e3 * p50


SKIP = 9.0       # an unmatched step end costs as much as a 3-scale jump
LOOK = 8         # a match may follow one up to this many step ends back


def aligned(o, spans):
    """(the traced span's device trace on the program's clock, the matched
    (copy end, host end) pairs), or None.

    The harness ties the trace to the host clock by a marker kernel at
    each end of the span. But the profiler drops a few operations in a
    hundred, markers among them, and the trace's clock runs apart from the
    host's by up to 3.4%, unevenly (PERF.md, Open questions). Each decode
    step ends in the host's read of its argmax, and each prompt's prefill
    in the read of its first token: a device-to-host copy from which the
    host returns at once, so that copy's end and the end of the step's
    ``engine.decode.wait`` span, or of the ``engine.prefill`` span, are
    one moment on the two clocks. Each such end within 1 s of the span may
    match a copy ending within 0.2 s of it, in order, or none; the
    matching kept is the one whose offsets (copy end less host end) move
    least, a move from one match to the next costing its square in units
    of 0.2 ms plus 5% of the time between them, and each end left
    unmatched ``SKIP``. At least half the span's ends must match. Between
    matched copies the offset is interpolated, beyond them held. The
    window keeps its start, which the harness reads on the host's clock,
    and maps its end."""
    tr = o.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    w0, w1 = tr.window
    host = sorted([wt.t1 for _, wt in decode_steps(spans).values()]
                  + [x.t1 for x in spans if x.name == "engine.prefill"])
    host = [t for t in host if w0 - 1.0 <= t <= w1 + 1.0]
    inside = sum(1 for t in host if w0 <= t <= w1)
    ends = sorted(b for n, _, b in tr.ops if "DtoH" in n)
    cand = [ends[bisect.bisect_left(ends, t - 0.2):
                 bisect.bisect_right(ends, t + 0.2)] for t in host]
    # best[i][k]: (cost of the cheapest matching that ends with host end i
    # on its k-th candidate, the (i, k) matched before it or None)
    best: List[List[tuple]] = []
    for i, t in enumerate(host):
        row = []
        for e in cand[i]:
            d, top = e - t, (SKIP * i, None)
            for i2 in range(max(0, i - LOOK), i):
                scale = 2e-4 + 5e-2 * (t - host[i2])
                for k2, e2 in enumerate(cand[i2]):
                    if e2 < e:
                        c = best[i2][k2][0] + SKIP * (i - i2 - 1) \
                            + ((d - e2 + host[i2]) / scale) ** 2
                        if c < top[0]:
                            top = (c, (i2, k2))
            row.append(top)
        best.append(row)
    end = min(((best[i][k][0] + SKIP * (len(host) - 1 - i), (i, k))
               for i in range(len(host)) for k in range(len(cand[i]))),
              default=(0.0, None))[1]
    match = []
    while end is not None:
        i, k = end
        match.append((cand[i][k], host[i]))
        end = best[i][k][1]
    if not match or len(match) < inside / 2:
        _log(f"device clock: {len(match)} step ends matched a "
             f"device-to-host copy, {inside} inside the span; not read")
        return None
    pairs = np.array(match[::-1])
    x, off = pairs[:, 0], pairs[:, 0] - pairs[:, 1]

    def f(t):
        return t - np.interp(t, x, off)
    _log(f"device clock: the markers' map runs {1e3 * off[0]:.3f} ms ahead "
         f"at the span's first matched step end, {1e3 * off[-1]:.3f} ms at "
         f"its last; {len(pairs)} step ends matched, {inside} inside the "
         f"span")
    a = np.array([(x0, x1) for _, x0, x1 in tr.ops])
    a0, a1 = f(a[:, 0]), f(a[:, 1])
    ops = [(n, float(p), float(q)) for (n, _, _), p, q in zip(tr.ops, a0, a1)]
    return devtrace.Trace(ops, (w0, float(f(w1))), tr.skew), pairs


def _span_trace(o):
    """(the aligned trace, spans) where both exist, else None."""
    spans = records(o)
    got = None if spans is None else aligned(o, spans)
    return None if got is None else (got[0], spans)


def decode_ops_per_step(o) -> Optional[float]:
    """Device operations starting inside [launch start, wait end] of the
    traced span's decode steps, over those steps."""
    got = _span_trace(o)
    if got is None:
        return None
    tr, spans = got
    w0, w1 = tr.window
    steps = [(ln, wt) for ln, wt in decode_steps(spans).values()
             if ln.t0 >= w0 and wt.t1 <= w1]
    if not steps:
        return None
    starts = sorted(a for _, a, _ in tr.ops)
    n = sum(bisect.bisect_right(starts, wt.t1)
            - bisect.bisect_left(starts, ln.t0) for ln, wt in steps)
    return n / len(steps)


def overlap_s(ivs: List[Tuple[float, float]], spans) -> float:
    """Seconds of the sorted, disjoint intervals ``ivs`` inside the
    ``spans``."""
    starts = [x[0] for x in ivs]
    total = 0.0
    for x in spans:
        i = max(0, bisect.bisect_right(starts, x.t0) - 1)
        while i < len(ivs) and ivs[i][0] < x.t1:
            total += max(0.0, min(x.t1, ivs[i][1]) - max(x.t0, ivs[i][0]))
            i += 1
    return total


def launch_idle_share(o) -> Optional[float]:
    """Device-idle time inside ``engine.decode.launch`` spans, as a share
    (%) of the traced span: the part of its idle share that the host's
    launching leaves."""
    got = _span_trace(o)
    if got is None:
        return None
    tr, spans = got
    w0, w1 = tr.window
    launches = [x for x in spans if x.name == "engine.decode.launch"
                and x.t1 > w0 and x.t0 < w1]
    return 100.0 * overlap_s(tr.gaps(), launches) / tr.window_s
