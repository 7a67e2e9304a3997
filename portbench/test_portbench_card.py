"""The benchmark on the card (marker ``cuda``; skips without one). On the
GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda portbench/test_portbench_card.py

Each cell's control at the cell's own size and load, on three seeds: the
control (bf16 -> fp8, fp32 -> tf32) put in the program's place comes out
not correct, and the program's own readings lie within the cell's limits;
and one traced run through the command itself.
"""
import json
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from pbcore import harness  # noqa: E402
from pbcore.spec import HERE, ROOT, Bench  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("name", ["granite-3-8b.chat",
                                  "phi4-mini-3.8b.docqa"])
def test_the_control_fails_at_the_cells_size(card, name):
    bench = Bench()
    cell = bench.cell(name)
    for seed in (901, 902, 903):
        out = harness.run_cell(bench, cell, seed, 20.0, False, "cuda",
                               time.perf_counter(), control=True)
        c = out["checks"]
        assert not out["correct"], c
        assert all(v <= c[k]["limit"] for k, v in out["program"].items()), \
            (seed, out["program"])
        torch.cuda.empty_cache()


def test_a_traced_run_of_the_command(card):
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "granite-3-8b.chat", "--seed", "2147483701",
                        "--seconds", "10", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks" and out["breakdown"]["device_ops"]
