"""Distributed grouped scheduling (paper Appendix A).

At high arrival rates a single centralized best-fit scheduler exceeds the
millisecond placement budget (best-fit is O(n log n) per heartbeat batch).
Requests are round-robin sampled into N_group scheduler groups; group i only
places onto its own worker slice. Group sizing follows Eq. 8:

    1/(2e)  <=  r_i  <=  r(T_s),    sum r_i = r_a

- the lower bound keeps the extra-worker error below e (each group needs at
  least 1/(2e) workers; with ~half the groups rounding up one extra worker,
  the relative overhead stays under e);
- the upper bound keeps each group's scheduling latency under T_s, using the
  fitted t_sched(n) = a * n log n + b model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.placement import WorkerState, best_fit_place
from repro_torch.core.request import Request


@dataclasses.dataclass
class SchedLatencyModel:
    """t_sched(n) = a * n log2(n+1) + b, fitted from measurements."""
    a: float = 2e-6
    b: float = 1e-4

    def __call__(self, n: float) -> float:
        return self.a * n * math.log2(n + 1) + self.b

    def max_rate(self, t_s: float, heartbeat: float) -> float:
        """Largest per-heartbeat batch (as a rate) schedulable within t_s."""
        lo, hi = 1.0, 1e7
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            if self(mid) <= t_s:
                lo = mid
            else:
                hi = mid
        return lo / heartbeat

    @staticmethod
    def fit(ns: Sequence[int], ts: Sequence[float]) -> "SchedLatencyModel":
        ns = np.asarray(ns, np.float64)
        A = np.stack([ns * np.log2(ns + 1), np.ones(len(ns))], axis=1)
        (a, b), *_ = np.linalg.lstsq(A, np.asarray(ts, np.float64), rcond=None)
        return SchedLatencyModel(float(a), float(b))


def choose_group_count(rate: float, n_workers: int, *, error_budget: float,
                       t_s: float, heartbeat: float,
                       lat: SchedLatencyModel) -> int:
    """Eq. 8: groups small enough for the latency bound, large enough for the
    utilization bound (>= 1/(2e) workers per group)."""
    min_rate = 1.0 / (2.0 * error_budget)           # r_i lower bound
    max_rate = max(lat.max_rate(t_s, heartbeat), min_rate)
    n_hi = max(int(rate / min_rate), 1)             # groups can't be smaller
    n_lo = max(int(math.ceil(rate / max_rate)), 1)  # need at least this many
    n = max(n_lo, 1)
    n = min(n, n_hi, max(n_workers, 1))
    return max(n, 1)


class GroupedScheduler:
    """Round-robin request router over per-group best-fit schedulers."""

    def __init__(self, workers: List[WorkerState], n_groups: int):
        self.n_groups = max(n_groups, 1)
        self.groups: List[List[WorkerState]] = [
            [] for _ in range(self.n_groups)]
        for i, w in enumerate(workers):
            self.groups[i % self.n_groups].append(w)
        self._rr = 0

    def route(self, req: Request) -> int:
        g = self._rr
        self._rr = (self._rr + 1) % self.n_groups
        return g

    def place(self, req: Request, new_worker_factory=None
              ) -> Optional[WorkerState]:
        g = self.route(req)
        w = best_fit_place(self.groups[g], req, allow_new=True,
                           new_worker_factory=new_worker_factory)
        return w

    @property
    def workers(self) -> List[WorkerState]:
        return [w for g in self.groups for w in g]
