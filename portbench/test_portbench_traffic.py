"""The open-loop generator: the same seed gives the same arrivals and
tokens; every seed gives the same multiset of gaps and lengths in another
order; arrivals fill the window."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pbcore.spec import Bench  # noqa: E402

GEN = Bench(bench={"workloads": [], "end_to_end": [],
                   "per_layer": []}).generator("open_loop")
MIX = {"kind": "open_loop", "rate_per_s": 3.0,
       "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.9,
                  "min": 32, "max": 896},
       "output": {"dist": "uniform", "min": 16, "max": 64}}


def _key(arr):
    return [(a["due_s"], a["l_in"], a["l_out"], tuple(a["tokens"]))
            for a in arr]


def test_same_seed_same_traffic():
    a = GEN.generate(MIX, 2 ** 31 + 11, 40.0, 49155)
    b = GEN.generate(MIX, 2 ** 31 + 11, 40.0, 49155)
    assert _key(a) == _key(b)


def test_seeds_share_the_work_in_another_order():
    a = GEN.generate(MIX, 1, 40.0, 49155)
    b = GEN.generate(MIX, 2, 40.0, 49155)
    assert len(a) == len(b) == 120
    for k in ("l_in", "l_out"):
        assert sorted(x[k] for x in a) == sorted(x[k] for x in b)
        assert [x[k] for x in a] != [x[k] for x in b]
    gaps = [np.diff([x["due_s"] for x in arr]) for arr in (a, b)]
    np.testing.assert_allclose(np.sort(gaps[0])[:-1], np.sort(gaps[1])[:-1],
                               rtol=0, atol=0.5)
    assert all(0 <= x["due_s"] < 40.0 for x in a + b)
    assert all(2 <= t < 49155 for x in a for t in x["tokens"])
    assert all(len(x["tokens"]) == x["l_in"] for x in a)


def test_lengths_follow_their_distribution():
    lens = GEN.quantile_lengths(MIX["prompt"], 1001)
    assert lens.min() >= 32 and lens.max() == 896
    assert int(np.median(lens)) == 256
    u = GEN.quantile_lengths(MIX["output"], 490)
    assert u.min() == 16 and u.max() == 64
    assert np.bincount(u)[16:65].std() < 1.0     # every length alike

