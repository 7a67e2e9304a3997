"""The port's benchmark: one run of one cell.

  python3 portbench/run.py --workload granite-3-8b.chat --seed 7 \
      --seconds 40 --trace 0

Serves the cell's traffic through ``repro_torch``'s live Aladdin path on
the card, and prints as its last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; ``checks``, each number compared
beside its limit, comes last, and is also the last lines of standard
error. Everything else goes to standard error. Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), and if
a module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once
the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from pbcore import harness  # noqa: E402
from pbcore.spec import Bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        harness.log(f"needs {cell.chips} CUDA card(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    out = harness.run_cell(bench, cell, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        harness.log(f"loaded after the window: {bad}")
        return 4
    for name, c in out["checks"].items():
        harness.log(f"[check] {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
