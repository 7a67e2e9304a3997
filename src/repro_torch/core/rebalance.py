"""Output-length prediction-error re-balancing (paper §4.3, Algorithm 2).

Each worker accumulates an error state:
  l_e  — signed accumulated output-length error of its outstanding requests
         (underestimates add the *re-predicted* remainder l'_pred; finished
         overestimates add l_real - l_pred < 0),
  b_e  — signed batch-size error (underestimated requests are still occupying
         a slot they were not expected to: +1; early finishers: -1).

Per Eq. 4 a worker's decode-latency budget line is  k2·C + c2·b = T_dec - c3,
so the *equivalent latency error* of worker i is  err_i = k2·l_e_i + c2·b_e_i
(the paper's distance-to-origin |c_i|/sqrt(α² + β²) is err_i up to the common
normalization 1/sqrt(k2² + c2²)). Re-balancing moves not-yet-started new
requests from positive-error (over-utilized) workers to negative-error ones,
greedily minimizing Σ|err_i| while preserving feasibility."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.placement import WorkerState
from repro_torch.core.request import Request


class ErrorTracker:
    """Maintains (l_e, b_e) per worker from request completion events."""

    def __init__(self):
        self.l_e: Dict[int, float] = {}
        self.b_e: Dict[int, float] = {}

    def _ensure(self, wid: int):
        self.l_e.setdefault(wid, 0.0)
        self.b_e.setdefault(wid, 0.0)

    def on_finish(self, r: Request) -> None:
        """Request finished: if earlier than predicted, record overestimate."""
        if r.worker is None:
            return
        self._ensure(r.worker)
        if r.l_real < r.l_pred:
            self.l_e[r.worker] += (r.l_real - r.l_pred)
            self.b_e[r.worker] -= 1

    def on_underrun(self, r: Request, new_pred: int) -> None:
        """Request exceeded its prediction; re-predicted to new_pred."""
        if r.worker is None:
            return
        self._ensure(r.worker)
        self.l_e[r.worker] += new_pred
        self.b_e[r.worker] += 1
        r.repredicted = True
        r.l_pred = r.l_out + new_pred

    def decay(self, f: float = 0.5) -> None:
        """Forget old error after each heartbeat's re-balance acted on it."""
        for k in self.l_e:
            self.l_e[k] *= f
            self.b_e[k] *= f

    def err(self, wid: int, k2: float, c2: float) -> float:
        return k2 * self.l_e.get(wid, 0.0) + c2 * self.b_e.get(wid, 0.0)


def rebalance(workers: List[WorkerState], tracker: ErrorTracker,
              max_moves: int = 64) -> int:
    """Algorithm 2: adjust placement of new (not yet started) requests.
    Returns the number of moves made."""
    if len(workers) < 2:
        return 0
    # per-worker coefficients: in a heterogeneous fleet the same token error
    # costs different latency on different hardware (its own Eq. 4 line)
    coef = {w.id: (w.perf.decode.k2, w.perf.decode.c2) for w in workers}
    errs = {w.id: tracker.err(w.id, *coef[w.id]) for w in workers}
    moves = 0
    improved = True
    while improved and moves < max_moves:
        improved = False
        # most over-utilized worker with a movable new request
        for src in sorted(workers, key=lambda w: -errs[w.id]):
            if errs[src.id] <= 0 or not src.new_batch:
                continue
            # candidate destinations: most under-utilized first
            for dst in sorted(workers, key=lambda w: errs[w.id]):
                if dst.id == src.id or errs[dst.id] >= errs[src.id]:
                    continue
                moved = False
                for r in list(src.new_batch):
                    if r.cached_len > 0:
                        # a prefix-cache grant is only redeemable on the
                        # worker holding the blocks: moving the request
                        # would both void the discount and let dst's
                        # feasibility check see a prefill dst cannot price
                        continue
                    k2s, c2s = coef[src.id]
                    k2d, c2d = coef[dst.id]
                    new_src = errs[src.id] - (k2s * r.l_pred + c2s)
                    new_dst = errs[dst.id] + (k2d * r.l_pred + c2d)
                    if abs(new_src) + abs(new_dst) + 1e-12 < \
                            abs(errs[src.id]) + abs(errs[dst.id]) \
                            and dst.feasible([r]):
                        src.unplace(r)
                        dst.place(r)
                        errs[src.id] = new_src
                        errs[dst.id] = new_dst
                        moves += 1
                        moved = improved = True
                        break
                if moved:
                    break
            if improved:
                break
    return moves
