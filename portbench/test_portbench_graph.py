"""``decode_graph_share.chat``, the share of the window's decode steps run
by replaying the engine's CUDA graph, on synthetic spans: 100 where every
step's launch holds a replay, 0 where none does, the share between; and
nothing where there is nothing to read (no recorder, or a program whose
engine has no graph)."""
import pytest

pytest.importorskip("torch")

from pbcore import harness, progspans  # noqa: E402
from pbcore.serve import Served  # noqa: E402
from pbcore.spec import Bench  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402
from repro_torch.serving.spans import Span  # noqa: E402

NAME = "decode_graph_share.chat"


def _obs():
    """A window 0.9-1.2 s on the host's clock, untraced."""
    served = Served(t0=0.9, t_end=1.2, t_drained=1.3, requests=[], beats=[],
                    tokens_at_close=0)
    return harness.Obs(cell=None, cfg=None, seconds=0.3, setup_s=0.0,
                       served=served, observer=None, slo=None)


def _steps(replayed):
    """Records of a capture at set-up, a prefill step, then one decode step
    for each entry of ``replayed`` inside the window, a replay instant
    inside its launch where the entry is true; and a replayed decode step
    after the window, which is not counted."""
    rows = [("engine.decode.capture", 0.1, 0.1, -1, -1),
            ("engine.step", 0.92, 0.95, -1, -1),
            ("engine.prefill", 0.921, 0.949, 1, 7)]
    starts = [0.96 + 0.03 * j for j in range(len(replayed))] + [1.25]
    for t, r in zip(starts, list(replayed) + [True]):
        step = len(rows)
        rows += [("engine.step", t, t + 0.02, -1, -1),
                 ("engine.decode.launch", t, t + 0.001, step, -1)]
        if r:
            rows.append(("engine.decode.replay", t + 0.0005, t + 0.0005,
                         step + 1, -1))
        rows.append(("engine.decode.wait", t + 0.001, t + 0.019, step, -1))
    return [Span(i, *r) for i, r in enumerate(rows)]


def _read(monkeypatch, spans):
    monkeypatch.setattr(progspans, "records", lambda _: spans)
    return Bench().reader(NAME).read(_obs())


@pytest.mark.parametrize("replayed,share", [
    ([True] * 5, 100.0),
    ([False] * 5, 0.0),
    ([True, False, True, True], 75.0)])
def test_share_of_the_windows_decode_steps_replayed(monkeypatch, replayed,
                                                    share):
    assert _read(monkeypatch, _steps(replayed)) == pytest.approx(share)


def test_nothing_to_read_is_none(monkeypatch):
    # no recorder (or a ring that lost a record of the window)
    assert _read(monkeypatch, None) is None
    # no decode step inside the window
    assert _read(monkeypatch, _steps([])) is None
    # a program whose engine has no decode graph (the parent commit)
    monkeypatch.delattr(PagedEngine, "decode_replays")
    assert _read(monkeypatch, _steps([True] * 5)) is None
