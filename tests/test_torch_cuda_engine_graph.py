"""The paged engine's decode step as one CUDA graph an engine, on the card:
two engines sharing one fp32 copy of the weights serve the same requests
twice, replaying their graphs, then eagerly (each engine's graph set
aside, so ``_decode`` runs ``_decode_step`` on the same inputs), over more
than 20 decode steps an engine with slots freed and re-admitted and 1, some
and all slots active. Every step's logits and both KV pools are equal,
bit for bit: the graph holds the same kernels (B1, B3, cuBLAS's fp32
GEMMs) on the same shapes. Each engine captured once, at construction,
without touching its pools; it replayed once a decode step; and the
kernels' launch counters read what the eager run launched.

These tests need an NVIDIA card and nvcc (the kernels are built at first
use); without a card they skip. On the GPU machine:

  PYTHONPATH=src python -m pytest -q -m cuda \\
      tests/test_torch_cuda_engine_graph.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.request import ReqState, Request  # noqa: E402
from repro_torch.kernels.decode_attention import \
    paged_decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import EngineConfig, PagedEngine  # noqa: E402

pytestmark = pytest.mark.cuda

CFG = EngineConfig(max_batch=4, page_size=16, n_pages=64, max_pages_per_seq=8,
                   max_new_tokens=64)
# (d_model, heads, kv heads), heads of 64: granite's GQA group of 4,
# phi4-mini's of 3, and musicgen's GeGLU with sinusoidal positions
ARCHS = {"granite-3-8b": (512, 8, 2), "phi4-mini-3.8b": (384, 6, 2),
         "musicgen-medium": (256, 4, 4)}
# (iteration it arrives at, engine, prompt, output tokens): one slot, then
# some, then all four with more waiting, freed and re-admitted as they end
SCHEDULE = [(0, 0, 19, 26), (0, 1, 33, 9), (4, 0, 40, 12), (5, 1, 7, 30),
            (9, 0, 57, 20), (9, 0, 25, 7), (10, 1, 50, 14), (10, 1, 12, 18),
            (11, 1, 28, 11), (14, 0, 36, 16), (14, 0, 21, 9),
            (22, 1, 44, 10)]
COUNTERS = {"paged_decode": lambda: paged_decode_attention.launches,
            "rmsnorm": lambda: rmsnorm.launches,
            "flash": lambda: flash_attention.launches}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _serve(engines, vocab, eager):
    """Serve SCHEDULE on ``engines`` (one iteration each an engine per
    round); returns each engine's decode steps as (logits, active slots),
    the requests' tokens and the launch counters' deltas."""
    seen = [[] for _ in engines]
    for e, eng in enumerate(engines):
        if eager:
            eng._graph = None
        run = eng._decode

        def tapped(tokens, active, run=run, out=seen[e]):
            logits = run(tokens, active)
            out.append((logits.clone(), list(active)))
            return logits
        eng._decode = tapped
    gen = torch.Generator().manual_seed(4)
    reqs = []
    before = {k: f() for k, f in COUNTERS.items()}
    for it in range(400):
        for t, e, l_in, l_out in SCHEDULE:
            if t == it:
                r = Request(l_in=l_in, l_pred=l_out, l_real=l_out)
                r.tokens = torch.randint(2, vocab, (l_in,),
                                         generator=gen).tolist()
                reqs.append(r)
                engines[e].submit(r)
        for eng in engines:
            eng.step()
        if len(reqs) == len(SCHEDULE) and all(
                r.state == ReqState.FINISHED for r in reqs):
            break
    torch.cuda.synchronize()
    assert all(r.state == ReqState.FINISHED for r in reqs)
    return seen, [r.tokens for r in reqs], \
        {k: f() - before[k] for k, f in COUNTERS.items()}


@pytest.mark.parametrize("name", list(ARCHS))
def test_replayed_decode_equals_the_eager_step(card, name):
    d, hq, hkv = ARCHS[name]
    arch = dataclasses.replace(
        reduced(get_arch(name), n_layers=2, d_model=d, vocab=512, n_heads=hq,
                n_kv_heads=hkv, d_ff=2 * d),
        param_dtype="float32")
    params = LM(arch, device=card).init(
        torch.Generator(device=card).manual_seed(1))
    launched = {k: f() for k, f in COUNTERS.items()}
    first = PagedEngine(arch, params, CFG, device=card)
    pair = [first, PagedEngine(arch, params, CFG, device=card, w32=first.w32)]
    twins = [PagedEngine(arch, params, CFG, device=card, w32=first.w32)
             for _ in range(2)]
    torch.cuda.synchronize()
    for eng in pair + twins:
        assert eng.decode_captures == 1 and eng.decode_replays == 0
        assert not eng.kv_k.any() and not eng.kv_v.any()
    # the warm-up steps launched; the captures launched nothing
    per_step = {"paged_decode": arch.n_layers,
                "rmsnorm": 2 * arch.n_layers + 1, "flash": 0}
    assert {k: f() - launched[k] for k, f in COUNTERS.items()} == {
        k: 4 * 3 * n for k, n in per_step.items()}

    graph, toks_g, count_g = _serve(pair, arch.vocab, eager=False)
    eager, toks_e, count_e = _serve(twins, arch.vocab, eager=True)
    assert toks_g == toks_e
    assert count_g == count_e
    for eng, steps_g, steps_e in zip(pair, graph, eager):
        assert len(steps_g) >= 20
        assert eng.decode_replays == len(steps_g)
        sizes = {len(active) for _, active in steps_g}
        assert {1, CFG.max_batch} <= sizes and len(sizes) >= 3, sizes
        assert [a for _, a in steps_g] == [a for _, a in steps_e]
        for (lg, _), (le, _) in zip(steps_g, steps_e):
            assert torch.equal(lg, le)
    for eng, twin in zip(pair, twins):
        assert twin.decode_replays == 0
        assert torch.equal(eng.kv_k, twin.kv_k)
        assert torch.equal(eng.kv_v, twin.kv_v)
    n_steps = sum(len(s) for s in graph)
    assert count_g["paged_decode"] == n_steps * arch.n_layers
