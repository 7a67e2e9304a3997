"""The general open-loop traffic generator: every ``traffic/<mix>.json``
whose ``kind`` is ``open_loop`` is read here.

A mix fixes ``rate_per_s`` (the mean arrival rate) and ``prompt`` and
``output`` length distributions. The number of requests is
``round(rate_per_s * seconds)``, and every seed gets the same multiset of
inter-arrival gaps, prompt lengths and output lengths, in another order:
the gaps are the exponential distribution's quantiles at (i + 0.5) / n,
the lengths their distribution's quantiles, each list shuffled by the seed
on its own. So the seed changes the order of the work and the token ids,
never its amount. The gaps are scaled to fill the window, so arrivals lie
in [0, seconds).

Length distributions (integers, clipped to [min, max]):
  {"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}
  {"dist": "uniform", "min": a, "max": b}
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def quantile_lengths(spec: Dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / max(n, 1)
    kind = spec["dist"]
    lo, hi = int(spec["min"]), int(spec["max"])
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        x = np.rint(float(spec["median"]) * np.exp(float(spec["sigma"]) * z))
    elif kind == "uniform":
        x = lo + np.floor(u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def generate(mix: Dict, seed: int, seconds: float, vocab: int) -> List[Dict]:
    """[{due_s, l_in, l_out, tokens}] in arrival order; ``tokens`` are the
    prompt's ids in [2, vocab)."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(float(mix["rate_per_s"]) * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = gaps[rng.permutation(n)]
    # arrival i at the sum of the gaps before it; the n gaps fill the window
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) / gaps.sum() \
        * seconds
    l_in = quantile_lengths(mix["prompt"], n)[rng.permutation(n)]
    l_out = quantile_lengths(mix["output"], n)[rng.permutation(n)]
    out = []
    for i in range(n):
        toks = rng.integers(2, vocab, int(l_in[i]))
        out.append({"due_s": float(due[i]), "l_in": int(l_in[i]),
                    "l_out": int(l_out[i]), "tokens": toks})
    if not all(math.isfinite(r["due_s"]) and 0 <= r["due_s"] < seconds
               for r in out):
        raise AssertionError("open_loop: an arrival outside the window")
    return out
