"""The port's example drivers (``repro_torch.examples``) on the CPU: each
runs its ``main`` on a deterministic clock, so no test waits on the wall
clock, and finishes every request it submitted; ``serve_e2e`` also
autoscales, survives its injected failure and checkpoints."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart, serve_e2e  # noqa: E402


class _Clock:
    """Counter clock with uneven steps (the engines' iteration 'times')."""

    def __init__(self):
        self.n, self.t = 0, 0.0

    def __call__(self) -> float:
        self.n += 1
        self.t += 0.001 + 0.0003 * (self.n % 7)
        return self.t


@pytest.mark.parametrize("example", [quickstart, serve_e2e],
                         ids=["quickstart", "serve_e2e"])
def test_example_finishes_every_request(example, capsys):
    out = example.main(device="cpu", time_fn=_Clock())
    assert out["finished"] == out["submitted"] > 0
    assert "requests" in capsys.readouterr().out


def test_serve_e2e_scales_fails_over_and_checkpoints(capsys):
    out = serve_e2e.main(device="cpu", time_fn=_Clock())
    assert out["submitted"] == 51
    assert out["failures"] == 1
    assert out["peak_workers"] >= 2
    assert "checkpointed scheduler state" in capsys.readouterr().out


@pytest.mark.parametrize("example", [quickstart, serve_e2e],
                         ids=["quickstart", "serve_e2e"])
def test_example_cli_takes_a_device(example, capsys):
    example.cli(["--device", "cpu"])
    assert "requests" in capsys.readouterr().out
