"""Quickstart: Aladdin serving a reduced Llama-2-family model, the port's
twin of the reference's ``examples/quickstart.py``.

Shows the whole control loop on live engines: length prediction -> best-fit
placement (Alg. 1) -> continuous batching -> perf-model refit from traces
-> re-balancing. Runs on the CUDA card, or with ``--device cpu`` on the
CPU (the kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference's reduced model has d_model 64 over 4 heads, a head dim of
16, which kernels B1 and B2 do not take (D 64 or 128); this one has
d_model 256 over 4 heads, a head dim of 64. Request counts and seeds are
the reference's.
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
    """Serve 8 requests on 2 workers until drained; returns a summary.
    ``time_fn`` is the clock of the cluster, its engines and the requests'
    arrivals."""
    arch = reduced(get_arch("llama2-7b"), n_layers=2, d_model=256,
                   vocab=256)
    params = LM(arch, device=device).init(torch.Generator().manual_seed(0))
    cluster = ServingCluster(
        arch, params, SLO(ttft=5.0, atgt=1.0),
        engine_cfg=EngineConfig(max_batch=4, page_size=8, n_pages=128,
                                max_pages_per_seq=16),
        cfg=ClusterConfig(policy="aladdin"), n_workers=2, time_fn=time_fn,
        device=device)

    rng = np.random.default_rng(0)
    print("submitting 8 requests...")
    for _ in range(8):
        r = Request(l_in=int(rng.integers(8, 40)), l_pred=0,
                    l_real=int(rng.integers(4, 12)), arrival=time_fn())
        r.tokens = [int(x) for x in rng.integers(2, arch.vocab, r.l_in)]
        cluster.submit(r)

    cluster.run_until_drained()
    print(f"finished {len(cluster.finished)}/8, "
          f"SLO attainment {cluster.attainment():.2f}")
    for r in cluster.finished[:3]:
        print(f"  req {r.id}: l_in={r.l_in} generated={r.l_out} "
              f"ttft={r.ttft():.3f}s atgt={r.atgt() or 0:.3f}s/tok "
              f"worker={r.worker}")
    d = cluster.perf.decode
    print(f"fitted decode model: k2={d.k2:.2e} c2={d.c2:.2e} c3={d.c3:.2e}")
    print(f"fit max rel err: {cluster.perf.max_rel_err}")
    return {"submitted": 8, "finished": len(cluster.finished),
            "attainment": cluster.attainment(),
            "workers": len(cluster.workers)}


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
