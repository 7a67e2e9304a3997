"""Output-length prediction (paper §2.3): the deliberately-naive, *unbiased*
bucketed conditional mean over historical data, plus the conditional
re-prediction used by Algorithm 2 when a request overruns its estimate
(E[l_out | l_out > current, bucket])."""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np


class LengthPredictor:
    def __init__(self, bucket_edges: Sequence[int] = (64, 128, 256, 512,
                                                      1024, 2048, 4096)):
        self.edges = list(bucket_edges)
        self.samples: List[List[int]] = [[] for _ in range(len(self.edges) + 1)]
        self.default = 128.0

    def _bucket(self, l_in: int) -> int:
        return bisect.bisect_right(self.edges, l_in)

    def observe(self, l_in: int, l_out: int) -> None:
        b = self.samples[self._bucket(l_in)]
        b.append(l_out)
        if len(b) > 20000:
            del b[:10000]

    def fit(self, l_ins: Sequence[int], l_outs: Sequence[int]) -> None:
        for i, o in zip(l_ins, l_outs):
            self.observe(int(i), int(o))

    def predict(self, l_in: int) -> int:
        s = self.samples[self._bucket(l_in)]
        if not s:
            pooled = [x for b in self.samples for x in b]
            return int(np.mean(pooled)) if pooled else int(self.default)
        return int(np.mean(s))

    def repredict(self, l_in: int, generated: int) -> int:
        """Conditional mean of the REMAINING tokens given l_out > generated."""
        s = [x for x in self.samples[self._bucket(l_in)] if x > generated]
        if not s:
            return max(generated // 2, 16)      # tail fallback: geometric-ish
        return max(int(np.mean(s)) - generated, 1)

    def bias(self) -> float:
        """Mean signed error on the training data (should be ~0: unbiased)."""
        errs = []
        for bi, s in enumerate(self.samples):
            if s:
                m = np.mean(s)
                errs.extend([m - x for x in s])
        return float(np.mean(errs)) if errs else 0.0
