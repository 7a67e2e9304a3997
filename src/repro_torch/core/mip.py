"""Exact reference solver for the placement MIP (small instances only).

Branch-and-bound over request->worker assignments minimizing the number of
workers used, subject to the same constraints (b)-(e) as the heuristic. Used
by tests to certify Algorithm 1's near-optimality (best-fit is 1.7-competitive
for classical bin packing; the paper calls it near-optimal)."""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from repro_torch.core.placement import WorkerState
from repro_torch.core.request import Request


def exact_min_workers(requests: Sequence[Request],
                      worker_factory: Callable[[int], WorkerState],
                      max_workers: int = 6) -> Optional[int]:
    """Smallest number of workers that can feasibly hold all requests
    (requests are placed as one heartbeat batch, like the MIP in §4.2).
    Returns None if infeasible within max_workers."""
    reqs = sorted(requests, key=lambda r: -(r.l_in + r.l_pred))

    for n in range(1, max_workers + 1):
        workers = [worker_factory(i) for i in range(n)]
        if _assign(reqs, 0, workers):
            return n
    return None


def _assign(reqs: List[Request], i: int,
            workers: List[WorkerState]) -> bool:
    if i == len(reqs):
        return True
    r = reqs[i]
    tried_empty = False
    for w in workers:
        if not w.new_batch and not w.ongoing:
            if tried_empty:          # symmetry breaking: empties are identical
                continue
            tried_empty = True
        if w.feasible([r]):
            w.place(r)
            if _assign(reqs, i + 1, workers):
                return True
            w.unplace(r)
    return False
