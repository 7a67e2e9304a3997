"""The paged engine's static-shape decode step on the CPU, where it runs
eagerly: the masked write of every slot's KV leaves the pools exactly as
the indexed write of the active slots alone did (the engine's decode step
before it became one CUDA graph an engine), with the same logits; a CPU
engine captures and replays nothing; GeGLU's constants are made once a
(dtype, device), with the values a fresh constant has.

The same step captured and replayed on the card:
tests/test_torch_cuda_engine_graph.py."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.configs.base import PosEmb  # noqa: E402
from repro_torch.core.request import ReqState, Request  # noqa: E402
from repro_torch.kernels.decode_attention import \
    paged_decode_attention  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.common import (gated_mlp, rms_norm, rope,  # noqa: E402
                                       sinusoidal_pos)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import EngineConfig, PagedEngine  # noqa: E402
from repro_torch.serving.spans import RECORDER  # noqa: E402

CFG = EngineConfig(max_batch=6, page_size=4, n_pages=48, max_pages_per_seq=6,
                   max_new_tokens=32)
# (arch, d_model, heads, kv heads): GQA groups 4 and 3 (the cells'), and a
# GeGLU arch with sinusoidal positions (group 1)
ARCHS = {"granite-3-8b": (64, 8, 2), "phi4-mini-3.8b": (48, 6, 2),
         "musicgen-medium": (32, 4, 4)}
SUBSETS = {"none": [], "all": [0, 1, 2, 3, 4, 5], "one": [3],
           "random-0": None, "random-1": None, "random-2": None}


def _engine(name, seed=0):
    d, hq, hkv = ARCHS[name]
    arch = dataclasses.replace(
        reduced(get_arch(name), n_layers=2, d_model=d, vocab=96, n_heads=hq,
                n_kv_heads=hkv),
        param_dtype="float32")
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(seed))
    return PagedEngine(arch, params, CFG, device="cpu")


def _indexed_decode(eng, tokens, active_slots):
    """The decode step as the engine ran it before: the KV written at the
    active slots' positions only (``kv[i, pages, offs] = k[act]``)."""
    a = eng.arch
    hd = a.resolved_head_dim
    seg = eng.w32["seg0"]
    bt = torch.as_tensor(eng.block_tables)
    lengths = torch.as_tensor(eng.lengths)
    act = torch.as_tensor(active_slots, dtype=torch.long)
    x = eng.params["embed"][torch.as_tensor(tokens)].float()
    if a.tie_embeddings:
        x = x * math.sqrt(a.d_model)
    if a.pos_emb == PosEmb.SINUSOIDAL:
        x = x + sinusoidal_pos(lengths, a.d_model)
    pos = lengths[act].long()
    page_ids = bt[act, pos // eng.cfg.page_size].long()
    offs = (pos % eng.cfg.page_size).long()
    rope_pos = lengths[:, None].float()
    for i in range(a.n_layers):
        p = {k: t[i] for k, t in seg.items()}
        h = rms_norm(x, p["ln1"], a.norm_eps)
        q = (h @ p["wq"]).reshape(-1, a.n_heads, hd)
        k = (h @ p["wk"]).reshape(-1, a.n_kv_heads, hd)
        v = (h @ p["wv"]).reshape(-1, a.n_kv_heads, hd)
        if a.qkv_bias:
            q = q + p["bq"].reshape(a.n_heads, hd)
            k = k + p["bk"].reshape(a.n_kv_heads, hd)
            v = v + p["bv"].reshape(a.n_kv_heads, hd)
        if a.pos_emb == PosEmb.ROPE:
            q = rope(q[:, None], rope_pos, a.rope_theta)[:, 0]
            k = rope(k[:, None], rope_pos, a.rope_theta)[:, 0]
        eng.kv_k[i, page_ids, offs] = k[act]
        eng.kv_v[i, page_ids, offs] = v[act]
        att = paged_decode_attention(q.contiguous(), eng.kv_k[i],
                                     eng.kv_v[i], bt, lengths + 1)
        x = x + att.reshape(x.shape[0], -1) @ p["wo"]
        h = rms_norm(x, p["ln2"], a.norm_eps)
        x = x + gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
    x = rms_norm(x, eng.params["final_ln"], a.norm_eps)
    return x @ eng.w32["head"]


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("name", list(ARCHS))
def test_masked_write_leaves_the_pools_as_the_indexed_write(name, subset):
    eng = _engine(name)
    rng = np.random.default_rng(sorted(SUBSETS).index(subset))
    b = CFG.max_batch
    active = SUBSETS[subset]
    if active is None:
        active = sorted(rng.choice(b, int(rng.integers(1, b)),
                                   replace=False).tolist())
    # live KV everywhere, the null page too; each active slot owns distinct
    # pages and is part way into one of them; an idle slot is all zero
    gen = torch.Generator().manual_seed(7)
    eng.kv_k.copy_(torch.randn(eng.kv_k.shape, generator=gen))
    eng.kv_v.copy_(torch.randn(eng.kv_v.shape, generator=gen))
    pages = rng.permutation(np.arange(1, CFG.n_pages))
    for j, s in enumerate(active):
        n = int(rng.integers(1, CFG.max_pages_per_seq * CFG.page_size - 1))
        own = pages[j * CFG.max_pages_per_seq:(j + 1) * CFG.max_pages_per_seq]
        eng.block_tables[s] = own
        eng.lengths[s] = n
    tokens = rng.integers(0, eng.arch.vocab, b).astype(np.int64)
    kv0 = eng.kv_k.clone(), eng.kv_v.clone()

    got = eng._decode(tokens, active)
    kv_got = eng.kv_k.clone(), eng.kv_v.clone()
    eng.kv_k.copy_(kv0[0])
    eng.kv_v.copy_(kv0[1])
    want = _indexed_decode(eng, tokens, active)

    assert torch.equal(got, want)
    assert torch.equal(kv_got[0], eng.kv_k)
    assert torch.equal(kv_got[1], eng.kv_v)
    changed = (kv_got[0] != kv0[0]).any(dim=(0, 3, 4)).nonzero().tolist()
    assert sorted(map(tuple, changed)) == sorted(
        (int(eng.block_tables[s, eng.lengths[s] // CFG.page_size]),
         int(eng.lengths[s] % CFG.page_size)) for s in active)


def test_a_cpu_engine_captures_and_replays_nothing():
    eng = _engine("granite-3-8b")
    first = RECORDER.recorded
    reqs = []
    for n in (5, 9, 13):
        r = Request(l_in=n, l_pred=6, l_real=6)
        r.tokens = list(range(2, 2 + n))
        reqs.append(r)
        eng.submit(r)
    for _ in range(40):
        eng.step()
        if all(r.state == ReqState.FINISHED for r in reqs):
            break
    assert all(r.state == ReqState.FINISHED for r in reqs)
    assert eng.traces.decode_times
    assert (eng.decode_captures, eng.decode_replays) == (0, 0)
    assert eng._graph is None
    names = {s.name for s in RECORDER.spans() if s.index >= first}
    assert "engine.decode.launch" in names
    assert not names & {"engine.decode.capture", "engine.decode.replay"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_constants_are_made_once_with_the_same_values(monkeypatch,
                                                            dtype):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(3)) \
        .to(dtype)

    def fresh(v):
        return torch.tensor(v, dtype=dtype)
    inner = x + fresh(0.044715) * (x * x * x)
    want = x * (fresh(0.5) * (1.0 + torch.tanh(
        fresh(math.sqrt(2 / math.pi)) * inner)))
    assert torch.equal(common._gelu_tanh(x), want)
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    assert torch.equal(common._gelu_tanh(x), want)
    assert made == []
