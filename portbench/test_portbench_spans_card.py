"""The program's spans against the device trace, on the card (marker
``cuda``; skips without one). On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda portbench/test_portbench_spans_card.py

One traced run of the chat cell, its trace mapped onto the program's
clock by ``progspans.aligned`` (each decode step's and each prefill's
copy to the host ends as its span does), as the device readings map it:
at least 80% of the span's decode steps match a copy, and each matched
offset lies within 5 ms of the line between its neighbours' (a wrong
match would stray 20 ms or more; the largest such distance bounds the
interpolation's error); at least 99% of the device's busy time
falls inside the program's ``engine.step`` spans; and every operation
that starts between a decode step's neighbours starts between its
launch's start and its wait's end, to within that bound. The new readings
also hold together with the harness's own.
"""
import bisect
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pbcore import harness, progspans  # noqa: E402
from pbcore.spec import Bench  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_program_spans_line_up_with_the_device_trace(card, monkeypatch):
    seen = {}
    read = harness.read_metrics

    def keep(bench, cell, o, trace, device_info):
        seen["o"] = o
        return read(bench, cell, o, trace, device_info)
    monkeypatch.setattr(harness, "read_metrics", keep)
    bench = Bench()
    out = harness.run_cell(bench, bench.cell("granite-3-8b.chat"),
                           2147483713, 20.0, True, "cuda",
                           time.perf_counter())
    assert out["correct"], out["checks"]
    o = seen["o"]
    spans = progspans.records(o)
    assert o.trace is not None and o.trace.ops and spans is not None
    tr, pairs = progspans.aligned(o, spans)
    w0, w1 = tr.window
    by = {s.index: s for s in spans}
    decode = sorted(((by[k], ln, wt) for k, (ln, wt)
                     in progspans.decode_steps(spans).items()
                     if by[k].t0 >= w0 and by[k].t1 <= w1),
                    key=lambda d: d[0].t0)
    assert len(decode) >= 10
    # how far each matched offset lies off the line between its
    # neighbours': the interpolation's error between matched copies (the
    # clocks' rates differ unevenly, by up to 3.4%); a copy matched to the
    # wrong step would put it 20 ms or more off
    x, off = pairs[:, 0], pairs[:, 0] - pairs[:, 1]
    line = off[:-2] + (off[2:] - off[:-2]) * (x[1:-1] - x[:-2]) \
        / (x[2:] - x[:-2])
    tol = float(np.abs(off[1:-1] - line).max())
    print(f"[clock] {len(pairs)} step ends matched, {len(decode)} decode "
          f"steps inside the span; the offset {1e3 * off[0]:.3f} to "
          f"{1e3 * off[-1]:.3f} ms, off the line between its neighbours' by "
          f"{1e6 * tol:.1f} us at most")
    matched = set(pairs[:, 1].tolist())
    assert sum(wt.t1 in matched for _, _, wt in decode) >= 0.8 * len(decode)
    assert tol < 5e-3, pairs

    steps = sorted((s for s in spans if s.name == "engine.step"
                    and s.t1 > w0 and s.t0 < w1), key=lambda s: s.t0)
    inside = progspans.overlap_s(tr.busy(), steps)
    assert inside >= 0.99 * tr.busy_s(), (inside, tr.busy_s())

    ops = sorted((a, n) for n, a, _ in tr.ops)
    starts = [a for a, _ in ops]
    pos = {s.index: i for i, s in enumerate(steps)}
    for st, ln, wt in decode:
        i = pos[st.index]
        lo = steps[i - 1].t1 if i > 0 else w0
        hi = steps[i + 1].t0 if i + 1 < len(steps) else w1
        mine = ops[bisect.bisect_right(starts, lo):
                   bisect.bisect_left(starts, hi)]
        assert mine, st
        assert ln.t0 - tol <= mine[0][0] and mine[-1][0] <= wt.t1 + tol, \
            (st, ln, wt, mine[:2], mine[-2:], steps[i - 1])

    got = {k: v["value"] for k, v in out["metrics"].items()}
    split = got["decode_launch_ms.chat"] + got["decode_wait_ms.chat"]
    assert 0.9 * got["decode_iter_ms.chat"] <= split \
        <= got["decode_iter_ms.chat"], got
    assert got["refit_ms_per_beat.chat"] + got["schedule_ms_per_beat.chat"] \
        <= got["control_ms_per_beat.chat"], got
    assert got["launch_idle_share.chat"] <= got["idle_share.chat"], got
