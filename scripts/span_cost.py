#!/usr/bin/env python3
"""The serving loop's span recorder (``repro_torch.serving.spans``): its
cost on the host that drives the card.

  python3 scripts/span_cost.py [--workload granite-3-8b.chat] \
      [--seconds 15] [--seed 11]

1. Microseconds a record, each the least of 5 tight loops of 10^5 on a
   recorder of its own: a span (``begin`` and ``end``), an instant, and a
   span with the recorder off.
2. The cell's cluster, built as ``portbench`` builds it (weights from the
   seed, the fixed warm-up, the open loop), serves the cell's arrivals
   four times in one process with the process-wide recorder on, off, off,
   on (A B B A). For each window: the mean decode iteration (TraceBuffer
   wall of the decode steps ending inside it) and, with the recorder on,
   the records made a decode step and a heartbeat (window and drain).

Prints the card (``nvidia-smi`` name and power limit), one JSON line per
window, and a summary line: the mean decode iteration on and off, and the
recorder's cost a decode step (microseconds a span times records a decode
step) as a share of the iteration. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "portbench"))

N = 100_000


def per_record_us() -> dict:
    from repro_torch.serving.spans import SpanRecorder

    def least(fn, enabled=True):
        best = float("inf")
        for _ in range(5):
            rec = SpanRecorder()
            rec.enabled = enabled
            t = time.perf_counter()
            fn(rec)
            best = min(best, time.perf_counter() - t)
        return 1e6 * best / N

    def spans(rec):
        for _ in range(N):
            rec.end(rec.begin("engine.decode.launch"))

    def instants(rec):
        for _ in range(N):
            rec.instant("request.submit", 1)
    return {"span_us": least(spans), "instant_us": least(instants),
            "off_span_us": least(spans, enabled=False)}


def abba(bench, cell, seed: int, seconds: float, device) -> list:
    """Serve the cell's arrivals four times, the recorder on, off, off,
    on; one row a window."""
    from pbcore import harness, readings, serve
    from repro_torch.serving.spans import RECORDER
    cfg, w = cell.config, cell.workload
    arch = serve.port_arch(cfg)
    weights = serve.make_weights(cfg, seed, device)
    cluster = harness.build_cluster(cell, arch, weights, device)
    obs = serve.Observer(cluster, time.perf_counter)
    gen = bench.generator(cell.traffic["kind"])
    arrivals = gen.generate(cell.traffic, seed, seconds, cfg["vocab_size"])
    harness.warm_up(cluster, obs, arrivals,
                    int(w["engine"].get("prefill_chunk", 0)),
                    cfg["vocab_size"])
    rows = []
    try:
        for on in (True, False, False, True):
            RECORDER.enabled = on
            n0, k0 = RECORDER.recorded, len(obs.steps)
            served = serve.serve(cluster, obs, arrivals, seconds,
                                 drain_s=float(w["drain_s"]))
            o = harness.Obs(cell=cell, cfg=cfg, seconds=seconds,
                            setup_s=0.0, served=served, observer=obs,
                            slo=w["slo"])
            decode = sum(1 for s in obs.steps[k0:] if s.kind == "decode")
            made = RECORDER.recorded - n0
            rows.append({
                "recorder": "on" if on else "off",
                "decode_iter_ms": readings.iter_ms(o, "decode"),
                "decode_steps": decode, "beats": len(served.beats),
                "records": made,
                "records_per_decode_step": made / decode if decode else None,
                "records_per_beat": made / len(served.beats)
                if served.beats else None})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        RECORDER.enabled = True
    return rows


def summary(cost: dict, rows: list) -> dict:
    def mean(xs):
        return sum(xs) / len(xs)
    on = mean([r["decode_iter_ms"] for r in rows if r["recorder"] == "on"])
    off = mean([r["decode_iter_ms"] for r in rows if r["recorder"] == "off"])
    per_step = mean([r["records_per_decode_step"] for r in rows
                     if r["recorder"] == "on"])
    return {"decode_iter_ms_on": on, "decode_iter_ms_off": off,
            "records_per_decode_step": per_step,
            "cost_us_per_decode_step": cost["span_us"] * per_step,
            "cost_share_of_decode_iter": cost["span_us"] * per_step
            / (1e3 * off)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="granite-3-8b.chat")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from pbcore.spec import Bench
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    cost = per_record_us()
    print(json.dumps(cost), flush=True)
    bench = Bench()
    rows = abba(bench, bench.cell(args.workload), args.seed, args.seconds,
                "cuda")
    print(json.dumps(summary(cost, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
