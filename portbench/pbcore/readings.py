"""The arithmetic the metric readers share: tails over all requests,
iteration times, model FLOP shares and kernel rooflines. Frozen with the
benchmark; a reader returns None where its cell gave it nothing to read."""
from __future__ import annotations

import bisect
import sys
from typing import List, Optional

import numpy as np

from pbcore import work


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between ranks) of all ``values``."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def ttfts(o) -> List[float]:
    """Every arrived request's time to first token from its due time; one
    that never got it counts to the end of the drain (it missed)."""
    end = o.served.t_drained
    return [(first if first is not None else end) - due
            for due, first, _, _ in o.per_request()]


def atgts(o) -> List[float]:
    """Every arrived request's average time between its tokens as the
    client saw them: (last token - first token) / (l_real - 1); one that
    never finished counts to the end of the drain."""
    end = o.served.t_drained
    out = []
    for due, first, fin, n in o.per_request():
        if n <= 1:
            continue
        start = first if first is not None else due
        out.append(((fin if fin is not None else end) - start) / (n - 1))
    return out


def iter_ms(o, kind: str) -> Optional[float]:
    """Mean TraceBuffer time of the window's iterations of ``kind``."""
    walls = [s.wall for s in o.window_steps() if s.kind == kind]
    return 1e3 * sum(walls) / len(walls) if walls else None


def prefill_ms_per_ktok(o) -> Optional[float]:
    steps = [s for s in o.window_steps() if s.kind == "prefill"]
    tokens = sum(s.tokens for s in steps)
    return 1e6 * sum(s.wall for s in steps) / tokens if tokens else None


def step_flops(cfg, s) -> float:
    if s.kind == "decode":
        return work.decode_flops(cfg, s.tokens, s.context)
    if s.kind == "prefill":
        return sum(work.prefill_flops(cfg, n) for n in s.l_ins)
    return 0.0


def mfu(o, kinds) -> Optional[float]:
    """Model FLOPs of the window's iterations of ``kinds`` over their
    TraceBuffer wall time, as a share (%) of 989 TFLOP/s."""
    steps = [s for s in o.window_steps() if s.kind in kinds]
    wall = sum(s.wall for s in steps)
    if not wall:
        return None
    return 100.0 * sum(step_flops(o.cfg, s) for s in steps) / wall \
        / work.PEAK_FLOPS


def control_ms_per_beat(o) -> Optional[float]:
    """Mean host time of a window heartbeat outside its engine steps."""
    beats = o.window_beats()
    if not beats:
        return None
    steps = sorted((s.t0, s.t1) for s in o.observer.steps)
    t0s = [s[0] for s in steps]
    total = 0.0
    for b0, b1 in beats:
        i = bisect.bisect_left(t0s, b0)
        inner = 0.0
        while i < len(steps) and steps[i][0] < b1:
            inner += steps[i][1] - steps[i][0]
            i += 1
        total += (b1 - b0) - inner
    return 1e3 * total / len(beats)


def roofline(o, stem: str, count_name: str, bounds: List[float],
             launches: int, counter: str) -> Optional[float]:
    """Share (%) of the least time of the traced span's launches of one
    kernel (``bounds``, one per launch) in its device time: the union of
    the intervals of the operations whose names hold ``stem``. Where the
    profiler saw fewer launches than were made, the bound is of those it
    saw; a difference from the program's own counter is logged."""
    tr = o.trace
    if tr is None or not bounds:
        return None
    seen = tr.count(count_name)
    prog = o.launches.get(counter)
    if seen != launches or (prog is not None and prog != launches):
        print(f"[roofline] {stem}: the profiler saw {seen} launches, the "
              f"iterations made {launches}, the program's counter says "
              f"{prog}", file=sys.stderr, flush=True)
    busy = tr.busy_s([stem])
    if not seen or not busy:
        return None
    return 100.0 * sum(bounds) * (seen / launches) / busy


def paged_decode_bounds(o) -> List[float]:
    """B1's least time for each launch in the traced span: one a layer
    that attends, each decode iteration."""
    cfg, L = o.cfg, work.attn_layers(o.cfg)
    if not L:
        return []
    max_pages = int(o.cell.workload["engine"]["max_pages_per_seq"])
    bounds = []
    for s in o.span_steps():
        if s.kind == "decode":
            fl, by = work.paged_decode_work(cfg, s.tokens, s.context,
                                            max_pages)
            bounds += [work.bound_s(fl, by)] * L
    return bounds


def paged_decode_roofline(o) -> Optional[float]:
    bounds = paged_decode_bounds(o)
    return roofline(o, "paged_decode_kernel", "paged_decode_kernel_split",
                    bounds, len(bounds), "paged_decode")


def flash_f32_bounds(o) -> List[float]:
    """B2 fp32's least time for each launch in the traced span: one a
    layer that attends, each chunk of a chunked prefill."""
    cfg, L = o.cfg, work.attn_layers(o.cfg)
    if not L:
        return []
    chunk = int(o.cell.workload["engine"].get("prefill_chunk", 0))
    bounds = []
    for s in o.span_steps():
        if s.kind != "prefill":
            continue
        for n in s.l_ins:
            for rows, done in work.chunk_plan(n, chunk):
                fl, by = work.flash_f32_work(cfg, rows, done)
                bounds += [work.bound_s(fl, by)] * L
    return bounds


def flash_f32_roofline(o) -> Optional[float]:
    bounds = flash_f32_bounds(o)
    return roofline(o, "flash_fwd_f32", "flash_fwd_f32_kernel", bounds,
                    len(bounds), "flash_f32")


def idle_share(o) -> Optional[float]:
    tr = o.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
