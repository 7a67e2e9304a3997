"""The frozen counts on hand-worked shapes, and the tails and rates taken
over all requests and the whole window."""
import types

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pbcore import readings, work  # noqa: E402
from pbcore.serve import Step  # noqa: E402

CFG = {"num_hidden_layers": 2, "hidden_size": 4, "num_attention_heads": 2,
       "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 8,
       "vocab_size": 10}


def test_counts_by_hand():
    # q 4x4, k and v 4x2 each, o 4x4, gated MLP 3 x 4x8, two norms of 4
    assert work.layer_params(CFG) == 16 + 16 + 16 + 96 + 8
    assert work.token_flops(CFG) == 2 * (2 * 152 + 4)
    assert work.head_flops(CFG) == 80
    # 3 query rows against 1, 2 and 3 keys: 6 pairs, 4 * Hq * hd a pair,
    # both layers; plus 3 tokens and one head
    assert work.prefill_flops(CFG, 3) == 616 * 3 + 4 * 2 * 2 * 6 * 2 + 80
    assert work.decode_flops(CFG, 2, 10) == (616 + 80) * 2 + 16 * 10 * 2
    fl, by = work.paged_decode_work(CFG, 2, 10, 3)
    assert fl == 4 * 10 * 2 * 2
    assert by == (2 * 10 * 1 * 2 + 2 * 2 * 2 * 2) * 4 + 2 * 3 * 4 + 2 * 4
    assert work.chunk_plan(600, 256) == [(256, 0), (256, 256), (88, 512)]
    assert work.chunk_plan(200, 256) == [] and work.chunk_plan(9, 0) == []
    fl, by = work.flash_f32_work(CFG, 3, 5)       # pairs 3 * 5 + 6
    assert fl == 4 * 2 * 2 * 21
    assert by == (2 * 3 * 2 * 2 + 2 * 8 * 1 * 2) * 4 + 4
    assert work.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def _obs(per, steps=(), t0=0.0, t_end=10.0, drained=12.0, tokens=50):
    served = types.SimpleNamespace(t0=t0, t_end=t_end, t_drained=drained,
                                   tokens_at_close=tokens, beats=[])
    return types.SimpleNamespace(
        per_request=lambda: per, served=served, seconds=t_end - t0,
        cfg=CFG, window_steps=lambda: list(steps))


def test_tails_over_every_request():
    rng = np.random.default_rng(0)
    due = np.sort(rng.uniform(0, 10, 100))
    ttft = rng.lognormal(-2, 1, 100)
    per = [(d, d + t, d + t + 1.0, 11) for d, t in zip(due, ttft)]
    o = _obs(per)
    assert readings.percentile(readings.ttfts(o), 90) == pytest.approx(
        np.percentile(ttft, 90))
    # not the median of per-chunk tails
    chunks = np.median([np.percentile(c, 90) for c in np.split(ttft, 10)])
    assert readings.percentile(readings.ttfts(o), 90) != pytest.approx(
        chunks)
    assert readings.atgts(o) == pytest.approx([0.1] * 100)
    # a request that never came counts to the drain's end, and misses
    per[0] = (per[0][0], None, None, 11)
    assert readings.ttfts(_obs(per))[0] == pytest.approx(12.0 - per[0][0])


def test_rates_and_mfu_over_the_window():
    steps = [Step(1, 0, 1, "decode", wall=0.5, tokens=2, context=10),
             Step(2, 1, 2, "prefill", wall=0.25, tokens=3, l_ins=(3,)),
             Step(1, 2, 3, "idle")]
    o = _obs([], steps)
    assert o.served.tokens_at_close / o.seconds == 5.0
    dec = work.decode_flops(CFG, 2, 10)
    pre = work.prefill_flops(CFG, 3)
    assert readings.mfu(o, ("decode",)) == pytest.approx(
        100 * dec / 0.5 / 989e12)
    assert readings.mfu(o, ("decode", "prefill")) == pytest.approx(
        100 * (dec + pre) / 0.75 / 989e12)
    assert readings.iter_ms(o, "prefill") == pytest.approx(250.0)
    assert readings.prefill_ms_per_ktok(o) == pytest.approx(0.25e6 / 3)
    assert readings.mfu(_obs([], []), ("decode",)) is None
