"""The readings a cell's check limit is set from, in one process.

  python3 portbench/control.py --workload granite-3-8b.chat \
      --seeds 1,2,3 --seconds 15

For each seed, a whole run of the cell (its set-up, a window of
``--seconds`` at the cell's own load, its drain) checked with the control,
the plain reference computed one step below the precision the
configuration states (bf16 -> fp8, fp32 -> tf32), put in the program's
place over the same sample of requests. Prints one JSON line a seed: the
program's readings (``max_logit_gap``, ``max_logit_err``: the lower
readings, over sound runs), the control's (the upper readings) beside
each limit, and ``correct``, which judges the control and so comes out
false where the limits separate the two.
"""
import time

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

from pbcore import harness  # noqa: E402
from pbcore.spec import Bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 3
    bench = Bench()
    cell = bench.cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = harness.run_cell(bench, cell, seed, args.seconds, False,
                               "cuda", time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": out["program"],
                          "control": {k: out["checks"][k]["value"] for k
                                      in out["program"]},
                          "limits": {k: out["checks"][k]["limit"] for k
                                     in out["program"]},
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "tokens": out["checks"]["tokens_compared"]["value"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
