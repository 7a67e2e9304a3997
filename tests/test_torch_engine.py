"""The port's paged engine on the CPU: twins of the reference engine's tests
(tests/test_engine.py, and the preemption and chunked-prefill tests of
tests/test_extras.py), and token-for-token agreement with the JAX
``PagedEngine`` on the same converted weights and requests."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.request import ReqState as JaxReqState  # noqa: E402
from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JaxPagedEngine  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.core.request import ReqState, Request  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import EngineConfig, PagedEngine  # noqa: E402

ENGINE_KW = dict(max_batch=4, page_size=8, n_pages=128, max_pages_per_seq=16,
                 max_new_tokens=64)


def _setup(param_dtype="float32", **cfg):
    arch = dataclasses.replace(
        reduced(get_arch("granite-3-8b"), n_layers=2, d_model=64, vocab=128),
        param_dtype=param_dtype)
    model = LM(arch, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = PagedEngine(arch, params, EngineConfig(**{**ENGINE_KW, **cfg}),
                      device="cpu")
    return arch, model, params, eng


def _reference_generate(model, params, prompt, n_new):
    """No-cache oracle: re-prefill the whole sequence for every token."""
    seq = list(prompt)
    out = []
    for _ in range(n_new):
        logits, _ = model.prefill(params, torch.tensor([seq]))
        out.append(int(logits.argmax(-1)))
        seq.append(out[-1])
    return out


def _req(prompt, n):
    r = Request(l_in=len(prompt), l_pred=n, l_real=n)
    r.tokens = list(prompt)
    return r


def test_engine_matches_model_single():
    arch, model, params, eng = _setup()
    rng = np.random.default_rng(0)
    prompt = [int(x) for x in rng.integers(2, arch.vocab, 12)]
    ref = _reference_generate(model, params, prompt, 8)
    req = _req(prompt, 8)
    eng.submit(req)
    while req.state != ReqState.FINISHED:
        eng.step()
    assert req.tokens[len(prompt):] == ref


def test_engine_continuous_batching_isolation():
    """Two interleaved requests must each match their solo generation."""
    arch, model, params, eng = _setup()
    rng = np.random.default_rng(1)
    p1 = [int(x) for x in rng.integers(2, arch.vocab, 10)]
    p2 = [int(x) for x in rng.integers(2, arch.vocab, 17)]
    ref1 = _reference_generate(model, params, p1, 6)
    ref2 = _reference_generate(model, params, p2, 6)
    r1, r2 = _req(p1, 6), _req(p2, 6)
    eng.submit(r1)
    eng.step()                      # prefill r1
    eng.step()                      # decode r1 once
    eng.submit(r2)                  # r2 arrives mid-flight
    for _ in range(40):
        eng.step()
        if r1.state == ReqState.FINISHED and r2.state == ReqState.FINISHED:
            break
    assert r1.tokens[len(p1):] == ref1
    assert r2.tokens[len(p2):] == ref2


def test_engine_page_accounting():
    arch, _, _, eng = _setup(param_dtype="bfloat16")
    free0 = len(eng.free_pages)
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(3):
        r = _req([int(x) for x in rng.integers(2, arch.vocab, 9 + i)], 5)
        reqs.append(r)
        eng.submit(r)
    for _ in range(60):
        eng.step()
        if all(r.state == ReqState.FINISHED for r in reqs):
            break
    assert all(r.state == ReqState.FINISHED for r in reqs)
    assert len(eng.free_pages) == free0, "pages leaked"
    assert eng.traces.decode_batches, "decode traces recorded"
    assert eng.traces.prefill_inputs, "prefill traces recorded"


def test_engine_preemption_on_page_exhaustion():
    arch = reduced(get_arch("llama2-7b"), n_layers=2, d_model=32, vocab=64)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    # tiny pool: 15 usable pages of 8 tokens -> forces exhaustion
    eng = PagedEngine(arch, params, EngineConfig(
        max_batch=4, page_size=8, n_pages=16, max_pages_per_seq=8,
        max_new_tokens=64), device="cpu")
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(3):
        r = Request(l_in=24, l_pred=20, l_real=20)
        r.tokens = [int(x) for x in rng.integers(2, 64, 24)]
        reqs.append(r)
        eng.submit(r)
    for _ in range(200):
        eng.step()
        if all(r.state == ReqState.FINISHED for r in reqs):
            break
    assert all(r.state == ReqState.FINISHED for r in reqs), \
        [r.state for r in reqs]
    assert len(eng.free_pages) == 15, "pages leaked after churn"


def test_chunked_prefill_matches_full():
    """Sarathi-style chunked prefill must generate the same tokens as the
    one-shot prefill (fp32 weights: both paths then run the same
    precision, so no near-tie can split them)."""
    arch = dataclasses.replace(
        reduced(get_arch("llama2-13b"), n_layers=2, d_model=64, vocab=128),
        param_dtype="float32")
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prompt = [int(x) for x in rng.integers(2, arch.vocab, 21)]
    outs = {}
    for label, chunk in (("full", 0), ("chunked", 8)):
        eng = PagedEngine(arch, params, EngineConfig(
            max_batch=2, page_size=8, n_pages=64, max_pages_per_seq=16,
            prefill_chunk=chunk), device="cpu")
        r = _req(prompt, 6)
        eng.submit(r)
        for _ in range(30):
            eng.step()
            if r.state == ReqState.FINISHED:
                break
        assert r.state == ReqState.FINISHED
        outs[label] = r.tokens[len(prompt):]
    assert outs["chunked"] == outs["full"], outs


def _run_engine(eng, make_req, prompts, n_new, done_state):
    reqs = []
    for p in prompts:
        r = make_req(l_in=len(p), l_pred=n_new, l_real=n_new)
        r.tokens = list(p)
        reqs.append(r)
        eng.submit(r)
    for _ in range(200):
        eng.step()
        if all(r.state == done_state for r in reqs):
            break
    assert all(r.state == done_state for r in reqs)
    return [r.tokens for r in reqs], eng.traces


@pytest.mark.parametrize("name", ["granite-3-8b", "llama2-7b"])
@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_engine_tokens_match_jax_engine(name, prefill_chunk):
    """The port's and the reference's engines, on the same converted fp32
    weights and the same requests, generate identical tokens and record
    the same iteration shapes — one-shot and chunked prefill, with the
    three requests batched together and interleaved."""
    kw = dict(n_layers=2, d_model=64, vocab=128)
    ja = dataclasses.replace(jax_reduced(jax_get_arch(name), **kw),
                             param_dtype="float32")
    ta = dataclasses.replace(reduced(get_arch(name), **kw),
                             param_dtype="float32")
    jp = JaxLM(ja).init(jax.random.key(0))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    cfg = dict(ENGINE_KW, prefill_chunk=prefill_chunk)
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(2, ja.vocab, n)]
               for n in (12, 21, 30)]
    want, jt = _run_engine(JaxPagedEngine(ja, jp, JaxEngineConfig(**cfg)),
                           JaxRequest, prompts, 8, JaxReqState.FINISHED)
    got, tt = _run_engine(PagedEngine(ta, tp, EngineConfig(**cfg),
                                      device="cpu"),
                          Request, prompts, 8, ReqState.FINISHED)
    assert got == want
    assert tt.prefill_inputs == jt.prefill_inputs
    assert tt.decode_batches == jt.decode_batches
    assert tt.decode_contexts == jt.decode_contexts
    assert tt.kv_tokens == jt.kv_tokens and tt.kv_bytes == jt.kv_bytes


def test_engine_rejects_params_on_another_device():
    arch, _, params, _ = _setup()
    meta = {k: (v.to("meta") if not isinstance(v, dict) else v)
            for k, v in params.items()}
    with pytest.raises(ValueError):
        PagedEngine(arch, meta, EngineConfig(**ENGINE_KW), device="cpu")


def test_engines_share_one_fp32_copy_made_once(monkeypatch):
    """bf16 weights are promoted to fp32 once per weight set, not per
    step: a cluster's workers (those it spawns later too) read one fp32
    copy, made when the first worker is built; decode and chunked-prefill
    iterations promote nothing; an engine given that copy uses it."""
    from repro_torch.core.slo import SLO
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.cluster import ClusterConfig, ServingCluster
    arch = reduced(get_arch("granite-3-8b"), n_layers=2, d_model=64,
                   vocab=128)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    assert params["seg0"]["wq"].dtype == torch.bfloat16
    calls = []
    promote = engine_mod.decode_weights
    monkeypatch.setattr(engine_mod, "decode_weights",
                        lambda *a: calls.append(1) or promote(*a))
    cfg = EngineConfig(**{**ENGINE_KW, "prefill_chunk": 8})
    cluster = ServingCluster(arch, params, SLO(ttft=30.0, atgt=5.0),
                             engine_cfg=cfg, cfg=ClusterConfig(),
                             n_workers=2, device="cpu")
    cluster._spawn_worker()
    engines = [w.engine for w in cluster.workers.values()]
    engines.append(PagedEngine(arch, params, cfg, device="cpu",
                               w32=cluster.w32))
    assert len(calls) == 1 and len(engines) == 4
    e1 = engines[0]
    for k, t in e1.w32["seg0"].items():
        assert t.dtype == torch.float32 and t.shape == params["seg0"][k].shape
        assert torch.equal(t, params["seg0"][k].float()), k
        for e in engines[1:]:
            assert t.data_ptr() == e.w32["seg0"][k].data_ptr(), k
    for e in engines[1:]:
        assert e1.w32["head"].data_ptr() == e.w32["head"].data_ptr()
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(2, arch.vocab, n)]
               for n in (12, 21)]
    for eng in engines:
        _run_engine(eng, Request, prompts, 6, ReqState.FINISHED)
    assert len(calls) == 1


def test_engines_on_trees_sharing_embed_read_their_own_layers():
    """Two weight trees that share the embedding but differ in one layer:
    engines built alone on each decode with their own layers."""
    arch = reduced(get_arch("granite-3-8b"), n_layers=2, d_model=64,
                   vocab=128)
    params = LM(arch, device="cpu").init(torch.Generator().manual_seed(0))
    other = {**params, "seg0": dict(params["seg0"])}
    other["seg0"]["wd"] = params["seg0"]["wd"].clone()
    other["seg0"]["wd"][1] *= -1
    assert other["embed"] is params["embed"]
    cfg = EngineConfig(**ENGINE_KW)
    e1 = PagedEngine(arch, params, cfg, device="cpu")
    e2 = PagedEngine(arch, other, cfg, device="cpu")
    assert torch.equal(e2.w32["seg0"]["wd"], other["seg0"]["wd"].float())
    assert not torch.equal(e1.w32["seg0"]["wd"], e2.w32["seg0"]["wd"])
    tokens = np.full((cfg.max_batch,), 7, np.int64)
    l1 = e1._decode(tokens, [0])
    l2 = e2._decode(tokens, [0])
    assert not torch.equal(l1, l2)


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunk_plan_is_what_the_engine_launches(monkeypatch, chunk):
    """``chip_smoke.chunk_plan``, from which the chunked serving phase
    counts B2's fp32 launches, lists the (Sq, Skv, q_offset) of every
    attention call the engine's chunked prefill makes, layer by layer,
    each with kv_len = Skv; a prompt of at most ``chunk`` tokens is
    prefilled in one shot and makes none."""
    import sys
    from pathlib import Path

    import repro_torch.serving.engine as engine_mod
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    calls = []
    attend = engine_mod.flash_attention

    def recorded(q, k, v, *, causal, q_offset, kv_len):
        calls.append((q.shape[1], k.shape[1], q_offset, int(kv_len[0])))
        assert causal and q.dtype == torch.float32
        return attend(q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=kv_len)
    monkeypatch.setattr(engine_mod, "flash_attention", recorded)
    arch, _, _, eng = _setup(prefill_chunk=chunk)
    rng = np.random.default_rng(4)
    want = []
    for n in (5, chunk, chunk + 1, 2 * chunk, 3 * chunk + 3, 57):
        r = _req([int(x) for x in rng.integers(2, arch.vocab, n)], 1)
        eng.submit(r)
        eng.step()                          # this prompt's prefill
        assert r.state == ReqState.DECODING
        eng.step()                          # its one decode step
        assert r.state == ReqState.FINISHED
        want += [s for s in chip_smoke.chunk_plan(n, chunk)
                 for _ in range(arch.n_layers)]
    assert [c[:3] for c in calls] == want
    assert all(c[3] == c[1] for c in calls)
