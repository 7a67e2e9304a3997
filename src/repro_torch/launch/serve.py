"""Serving launcher of the port.

Sizes an Aladdin worker for the H100 with the Eq. 5-6 search, assembles a
``ServingCluster`` of live ``PagedEngine`` workers on one CUDA card (all
sharing one weight set), runs the Aladdin control loop, and serves a
synthetic Poisson workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --rate 2 --duration 30 [--policy aladdin|jsq] [--workers 2] [--full]

Without ``--full`` the model is reduced (2 layers, d_model 64); with it the
architecture runs at its published width (``llama2-7b``: 32 layers, d_model
4096, bf16 weights of ~13.5 GB, random from ``--seed``). It runs on the
CUDA card; ``--device cpu`` runs the plain PyTorch versions instead.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO
from repro_torch.core.worker_config import optimal_worker_config
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.serving.cluster import ClusterConfig, ServingCluster
from repro_torch.serving.engine import EngineConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--policy", default="aladdin")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--ttft", type=float, default=10.0)
    ap.add_argument("--atgt", type=float, default=2.0)
    ap.add_argument("--full", action="store_true",
                    help="serve the architecture at its published width")
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    arch = get_arch(args.arch)
    try:
        cfg = optimal_worker_config(arch, H100_SXM, SLO(args.ttft, args.atgt))
        print(f"[serve] Eq.5-6 optimal worker on {H100_SXM.name}: "
              f"{cfg.n_accelerators} GPUs ({cfg.bound}-bound)")
    except ValueError as e:
        print(f"[serve] worker config: {e}")
    if not args.full:
        arch = reduced(arch, n_layers=2, d_model=64, vocab=256)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = LM(arch, device=device).init(gen)
    cluster = ServingCluster(
        arch, params, SLO(args.ttft, args.atgt),
        engine_cfg=EngineConfig(max_batch=4, page_size=8, n_pages=256,
                                max_pages_per_seq=32),
        cfg=ClusterConfig(policy=args.policy, autoscale=args.autoscale,
                          max_workers=max(args.workers * 2, 4)),
        n_workers=args.workers, device=device)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    n = 0
    next_arrival = t0 + rng.exponential(1.0 / args.rate)
    while time.perf_counter() - t0 < args.duration:
        now = time.perf_counter()
        while now >= next_arrival:
            r = Request(l_in=int(rng.integers(8, 48)), l_pred=0,
                        l_real=int(rng.integers(4, 16)), arrival=now)
            r.tokens = [int(x) for x in rng.integers(2, arch.vocab, r.l_in)]
            cluster.submit(r)
            n += 1
            next_arrival += rng.exponential(1.0 / args.rate)
        cluster.heartbeat()
    cluster.run_until_drained()
    print(f"[serve] {len(cluster.finished)}/{n} finished | attainment "
          f"{cluster.attainment():.2f} | workers={len(cluster.workers)} | "
          f"decode fit err={cluster.perf.max_rel_err.get('decode', -1):.3f}"
          f" | device={device}")


if __name__ == "__main__":
    main()
