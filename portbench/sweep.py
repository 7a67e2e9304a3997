"""Rate sweep of a cell's traffic, to find its knee, in one process.

  python3 portbench/sweep.py --workload granite-3-8b.chat \
      --rates 1.5,2,2.5,3,3.5,4 --seconds 30 --seed 1

Builds the cell's cluster once, warms it up, then serves the cell's mix
at each rate in turn (a window of ``--seconds``, then a drain), printing
one JSON line per rate: requests, the share that met both limits (a
request that never finished misses), the backlog (arrived, not finished)
at the window's middle and end, TTFT p50/p90, the client's ATGT p90,
output tokens/s and the mean iteration times. The knee is the highest
rate at which at least 90% meet both limits and the backlog at the end is
no larger than at the middle.
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

from pbcore import harness, readings, serve  # noqa: E402
from pbcore.spec import Bench  # noqa: E402


def backlog(o, t) -> int:
    return sum(1 for due, _, fin, _ in o.per_request()
               if due <= t and (fin is None or fin > t))


def mean_backlog(o, a, b, n=50) -> float:
    """Mean backlog over the window's fractions [a, b)."""
    s = o.served
    return sum(backlog(o, s.t0 + o.seconds * (a + (b - a) * i / n))
               for i in range(n)) / n


def stall_watch(cluster, seen):
    """Log, once a request, why a request queued over 2 s was refused by
    every worker (Algorithm 1's constraints (b)-(e), and Eq. 3)."""
    def on_beat(now):
        for r in cluster.queued:
            if now - r.arrival > 2.0 and r.id not in seen:
                seen.add(r.id)
                why = {w.id: {c: getattr(w.state, f"_constraint_{c}")([r])
                              for c in "bcde"}
                       | {"batch": w.state.batch_size,
                          "ongoing": len(w.state.ongoing),
                          "wctx": round(w.state.weighted_context(), 1)}
                       for w in cluster.workers.values()}
                harness.log(f"[stall] request {r.id} l_in {r.l_in} l_pred "
                            f"{r.l_pred} queued {now - r.arrival:.2f} s; "
                            f"{why}; Eq. 3 {cluster.perf.decode}; Eq. 2 "
                            f"{cluster.perf.prefill}")
    return on_beat


def row(o, rate) -> dict:
    slo = o.slo
    ok = 0
    per = o.per_request()
    end = o.served.t_drained
    for due, first, fin, n in per:
        if first is None or fin is None:
            continue
        atgt = (fin - first) / max(n - 1, 1)
        ok += (first - due <= slo["ttft_s"]) and (atgt <= slo["atgt_s"])
    s = o.served
    return {"rate_per_s": rate, "requests": len(per),
            "finished": sum(1 for p in per if p[2] is not None),
            "attainment": ok / max(len(per), 1),
            "backlog_mid": backlog(o, s.t0 + o.seconds / 2),
            "backlog_end": backlog(o, s.t_end),
            "backlog_q2_q4": [mean_backlog(o, 0.25, 0.5),
                              mean_backlog(o, 0.75, 1.0)],
            "ttft_p50_s": readings.percentile(readings.ttfts(o), 50),
            "ttft_p90_s": readings.percentile(readings.ttfts(o), 90),
            "atgt_p90_ms": 1e3 * readings.percentile(readings.atgts(o), 90),
            "output_tokens_per_s": s.tokens_at_close / o.seconds,
            "prefill_iter_ms": readings.iter_ms(o, "prefill"),
            "decode_iter_ms": readings.iter_ms(o, "decode"),
            "drain_s": end - s.t_end}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 3
    bench = Bench()
    cell = bench.cell(args.workload)
    cfg, w = cell.config, cell.workload
    rates = [float(r) for r in args.rates.split(",")]
    arch = serve.port_arch(cfg)
    weights = serve.make_weights(cfg, args.seed, "cuda")
    cluster = harness.build_cluster(cell, arch, weights, "cuda")
    obs = serve.Observer(cluster, time.perf_counter)
    gen = bench.generator(cell.traffic["kind"])
    chunk = int(w["engine"].get("prefill_chunk", 0))
    mix = dict(cell.traffic, rate_per_s=max(rates))
    harness.warm_up(cluster, obs, gen.generate(
        mix, args.seed, args.seconds, cfg["vocab_size"]), chunk,
        cfg["vocab_size"])
    seen = set()
    harness.log(f"[sweep] set up in {time.perf_counter() - T_START:.1f} s")
    out = []
    for rate in rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        arrivals = gen.generate(mix, args.seed, args.seconds,
                                cfg["vocab_size"])
        served = serve.serve(cluster, obs, arrivals, args.seconds,
                             drain_s=float(w["drain_s"]),
                             on_beat=stall_watch(cluster, seen))
        o = harness.Obs(cell=cell, cfg=cfg, seconds=args.seconds,
                        setup_s=0.0, served=served, observer=obs,
                        slo=w["slo"])
        r = row(o, rate)
        out.append(r)
        print(json.dumps(r), flush=True)
    knee = [r["rate_per_s"] for r in out if r["attainment"] >= 0.9
            and r["backlog_end"] <= r["backlog_mid"]]
    print(json.dumps({"workload": args.workload,
                      "knee_rate_per_s": max(knee) if knee else None,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
