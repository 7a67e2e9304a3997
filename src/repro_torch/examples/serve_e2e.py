"""End-to-end serving driver, the port's twin of the reference's
``examples/serve_e2e.py``: a stream of batched requests against a small
model with the full Aladdin control plane — autoscaling up under load, a
worker failure mid-run (its requests re-queued), and a scheduler
checkpoint (``snapshot``). Runs on the CUDA card, or with ``--device
cpu`` on the CPU (the kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.examples.serve_e2e [--device cpu]

The reference's reduced model has d_model 64 over 4 heads, a head dim of
16, which kernels B1 and B2 do not take (D 64 or 128); this one has
d_model 256 over 4 heads, a head dim of 64. The control loop, request
counts and seeds are the reference's.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO
from repro_torch.device import DeviceLike
from repro_torch.models.model import LM
from repro_torch.serving.cluster import ClusterConfig, ServingCluster
from repro_torch.serving.engine import EngineConfig


def main(device: DeviceLike = None,
         time_fn: Callable[[], float] = time.perf_counter) -> dict:
    """Ramp the load over 30 heartbeats from one worker (autoscaling up to
    4), kill a worker at beat 12, checkpoint at beat 18, then drain;
    returns a summary. ``time_fn`` is the clock of the cluster, its
    engines and the requests' arrivals."""
    arch = reduced(get_arch("llama2-13b"), n_layers=2, d_model=256,
                   vocab=256)
    params = LM(arch, device=device).init(torch.Generator().manual_seed(1))
    cluster = ServingCluster(
        arch, params, SLO(ttft=10.0, atgt=2.0),
        engine_cfg=EngineConfig(max_batch=4, page_size=8, n_pages=128,
                                max_pages_per_seq=16),
        cfg=ClusterConfig(policy="aladdin", autoscale=True, min_workers=1,
                          max_workers=4),
        n_workers=1, time_fn=time_fn, device=device)

    rng = np.random.default_rng(7)
    submitted, requeued, peak_workers = 0, 0, 1
    t0 = time_fn()
    print("phase 1: ramping load (autoscale up)...")
    for beat in range(30):
        for _ in range(2 if beat > 8 else 1):
            r = Request(l_in=int(rng.integers(8, 32)), l_pred=0,
                        l_real=int(rng.integers(4, 10)), arrival=time_fn())
            r.tokens = [int(x) for x in rng.integers(2, arch.vocab, r.l_in)]
            cluster.submit(r)
            submitted += 1
        cluster.heartbeat()
        peak_workers = max(peak_workers, len(cluster.workers))
        if beat == 12:
            wid = next(iter(cluster.workers))
            requeued = cluster.inject_failure(wid)
            print(f"  !! injected failure on worker {wid}: "
                  f"{requeued} requests re-queued, "
                  f"{len(cluster.workers)} workers remain")
        if beat == 18:
            snap = cluster.snapshot()
            print(f"  checkpointed scheduler state "
                  f"({len(snap['queued'])} queued, perf k2="
                  f"{snap['perf']['k2']:.2e})")
    print(f"  workers now: {len(cluster.workers)} (autoscaled)")
    print("phase 2: draining...")
    cluster.run_until_drained(max_beats=400)
    dt = time_fn() - t0
    print(f"served {len(cluster.finished)}/{submitted} requests in {dt:.1f}s"
          f" | attainment {cluster.attainment():.2f} | "
          f"failures handled: {len(cluster.failed_events)}")
    assert len(cluster.finished) == submitted, "requests lost!"
    return {"submitted": submitted, "finished": len(cluster.finished),
            "attainment": cluster.attainment(),
            "failures": len(cluster.failed_events), "requeued": requeued,
            "peak_workers": peak_workers, "workers": len(cluster.workers)}


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
