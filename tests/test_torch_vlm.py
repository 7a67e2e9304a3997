"""The port's cross-attention (VLM) family against the reference's on the
same seeded inputs and converted weights: ``cross_attention_full`` and
``cross_attention_decode`` for a bf16 or an fp32 frontend into a bf16 or
fp32 layer, at 16 frontend tokens (the plain flash version's chunked form)
and 37 (its dense form, as the full width's 1601 takes); ``LM.prefill`` /
``decode_step`` / ``maybe_flush`` for reduced llama-3.2-vision-90b with 4
layers (two super-blocks of one dense and one cross-attention layer),
logits and every cache leaf, ``cross_kv`` included; the parameter
template, its conversion and ``init_cache``.

The tanh gates are zero at init, so a cross layer then adds nothing and
the logits do not depend on the frontend: every comparison here sets both
gates of every cross layer to 0.5 before either package sees the weights,
and one test checks that the frontend moves the logits.

The reference feeds an fp32 frontend to a bf16 model
(``tests/test_models_smoke.py``): jnp promotes the K/V projections, and
with them the cached ``cross_kv``, to fp32. bf16 generation is held
against the reference run layer by layer (``ExecConfig(scan_layers=
False)``), to which it is equal bit for bit here; the scanned reference
rounds fused bf16 chains differently (ROADMAP C9)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.models.model import ExecConfig  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from test_torch_generation import _check_cache, _leaves  # noqa: E402
from test_torch_models import _close_model  # noqa: E402

NAME = "llama-3.2-vision-90b"
KW = dict(d_model=64, vocab=128)
GATE = 0.5
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _archs(param_dtype, n_layers=4, frontend_tokens=16):
    kw = dict(KW, n_layers=n_layers)
    return tuple(dataclasses.replace(a, param_dtype=param_dtype,
                                     n_frontend_tokens=frontend_tokens)
                 for a in (jax_reduced(jax_get_arch(NAME), **kw),
                           reduced(get_arch(NAME), **kw)))


def _gated(jp, value=GATE):
    """The reference's params with both gates of every cross layer set to
    ``value``."""
    cross = dict(jp["seg0"]["cross"])
    for g in ("gate_attn", "gate_mlp"):
        cross[g] = jnp.full_like(cross[g], value)
    return {**jp, "seg0": {**jp["seg0"], "cross": cross}}


def _models(param_dtype, frontend_tokens=16, window=4, scan=True):
    ja, ta = _archs(param_dtype, frontend_tokens=frontend_tokens)
    jm = JaxLM(ja, exec_cfg=ExecConfig(recent_window=window,
                                       scan_layers=scan))
    jp = _gated(jm.init(jax.random.key(0)))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, LM(ta, device="cpu", recent_window=window), tp


def _array(rng, shape, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(rng.standard_normal(shape), _JDT[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(_TDT[dtype])


@pytest.mark.parametrize("tokens", [16, 37])
@pytest.mark.parametrize("layer,frontend", [("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32"),
                                            ("float32", "float32")])
def test_cross_attention_matches_jax(layer, frontend, tokens):
    """Prefill's output and K/V, then one decode token against those K/V,
    for cross layer 0 of the reduced arch. An fp32 frontend gives fp32
    K/V whatever the layer's type."""
    ja, ta = _archs(layer)
    jl = jax.tree.map(lambda t: t[0],
                      _gated(JaxLM(ja).init(jax.random.key(0)))["seg0"]
                      ["cross"])
    tl = params_from_jax_numpy(jax.tree.map(np.asarray, jl))
    rng = np.random.default_rng(tokens)
    xj, xt = _array(rng, (2, 12, 64), layer)
    fj, ft = _array(rng, (2, tokens, 64), frontend)
    want, (wk, wv) = jax_attention.cross_attention_full(xj, fj, jl, ja,
                                                        return_kv=True)
    got, (gk, gv) = attention.cross_attention_full(xt, ft, tl, ta,
                                                   return_kv=True)
    assert got.dtype == _TDT[layer] and got.shape == (2, 12, 64)
    kv_dtype = torch.promote_types(_TDT[layer], _TDT[frontend])
    assert gk.dtype == gv.dtype == kv_dtype
    assert gk.shape == tuple(wk.shape) == (2, tokens, ta.n_kv_heads,
                                           ta.resolved_head_dim)
    _close_model(got, want, layer)
    for g, w in ((gk, wk), (gv, wv)):
        _close_model(g, w, "float32" if kv_dtype == torch.float32
                     else layer)
    qj, qt = _array(rng, (2, 64), layer)
    want = jax_attention.cross_attention_decode(qj, (wk, wv), jl, ja)
    got = attention.cross_attention_decode(
        qt, tuple(torch.from_numpy(np.array(t, np.float32)).to(kv_dtype)
                  for t in (wk, wv)), tl, ta)
    assert got.dtype == _TDT[layer] and got.shape == (2, 64)
    _close_model(got, want, layer)


@pytest.mark.parametrize("tokens", [16, 37])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_vlm_generation_matches_jax(param_dtype, tokens):
    """Prefill logits and every cache leaf, then decode_step logits over 3
    steps with a flush after the 2nd (recent window 4) and every cache
    leaf again, with an fp32 frontend as the reference's smoke test feeds
    it."""
    jm, jp, tm, tp = _models(param_dtype, tokens,
                             scan=param_dtype == "float32")
    rng = np.random.default_rng(3)
    toks = rng.integers(2, jm.arch.vocab, (2, 20))
    fr = rng.standard_normal((2, tokens, 64)).astype(np.float32)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks),
                        frontend=jnp.asarray(fr), s_max=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), s_max=32,
                        frontend=torch.from_numpy(fr))
    assert tl.dtype == torch.float32 and tl.shape == (2, jm.arch.vocab)
    assert tc[0]["cross_kv"][0].dtype == torch.float32
    _close_model(tl, jl, param_dtype)
    _check_cache(tc, jc, param_dtype)
    for i, tok in enumerate(rng.integers(2, jm.arch.vocab, (3, 2))):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_model(tl, jl, param_dtype)
        if i == 1:
            jc, tc = jm.maybe_flush(jc), tm.maybe_flush(tc)
            assert tc[0]["dense"]["big_len"] == 22
    assert tc[0]["dense"]["rec_len"] == 1
    _check_cache(tc, jc, param_dtype)


def test_vlm_bf16_frontend_stays_bf16():
    """A bf16 frontend into a bf16 model: cross K/V stay bf16 (on the card
    B2's bf16 path then runs), and the logits match the reference."""
    jm, jp, tm, tp = _models("bfloat16", 37, scan=False)
    rng = np.random.default_rng(4)
    toks = rng.integers(2, jm.arch.vocab, (2, 12))
    fj, ft = _array(rng, (2, 37, 64), "bfloat16")
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), frontend=fj)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), frontend=ft)
    assert tc[0]["cross_kv"][1].dtype == torch.bfloat16
    _close_model(tl, jl, "bfloat16")
    _check_cache(tc, jc, "bfloat16")


def test_vlm_param_template_and_conversion_match_jax():
    """The two-level vlm_super tree: the reference's leaf names and shapes
    ({"dense": (n_super, inner, ...), "cross": (n_super, ...)}), and
    ``params_from_jax_numpy`` key for key, value for value."""
    ja, ta = _archs("bfloat16", n_layers=6, frontend_tokens=16)
    ja = dataclasses.replace(ja, cross_attn_every=3)
    ta = dataclasses.replace(ta, cross_attn_every=3)
    jt, tt = JaxLM(ja).param_template(), LM(ta, device="cpu")
    assert [(g.kind, g.n, g.inner) for g in tt.segments] == \
        [("vlm_super", 2, 2)]
    tt = tt.param_template()

    def shapes(t, idx):
        return {k: shapes(v, idx) if isinstance(v, dict) else v[idx]
                for k, v in t.items()}
    assert shapes(tt, 0) == shapes(jt, 0)
    assert tt["seg0"]["dense"]["wq"][0] == (2, 2, 64, 64)
    assert tt["seg0"]["cross"]["gate_attn"] == ((2, 1), 0.0)
    jp = JaxLM(ja).init(jax.random.key(0))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    want, got = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(w, np.float32), path)


def test_vlm_init_draws_zero_gates():
    _, ta = _archs("bfloat16")
    params = LM(ta, device="cpu").init(torch.Generator().manual_seed(0))
    cross = params["seg0"]["cross"]
    for g in ("gate_attn", "gate_mlp"):
        assert cross[g].shape == (2, 1) and not cross[g].any()
    assert torch.all(cross["ln1"] == 1)
    assert params["seg0"]["dense"]["wq"].shape == (2, 1, 64, 64)


@pytest.mark.parametrize("frontend_tokens", [0, 37])
def test_vlm_init_cache_matches_jax(frontend_tokens):
    """The zero cache's layout; ``frontend_tokens`` 0 takes the arch's
    count (16 reduced)."""
    jm, _, tm, _ = _models("bfloat16", window=8)
    want = {p: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for p, v in _leaves(jm.init_cache(2, 24, frontend_tokens))}
    got = dict(_leaves(tm.init_cache(2, 24, frontend_tokens)))
    assert sorted(got) == sorted(want)
    for p, v in got.items():
        if isinstance(v, int):
            assert v == 0
        else:
            assert (tuple(v.shape), str(v.dtype).replace("torch.", "")) \
                == want[p], p
            assert not v.any(), p
    assert got["[0]/cross_kv[0]"].shape[2] == (frontend_tokens or 16)


def test_vlm_frontend_moves_the_logits():
    """With the gates set, another frontend gives other logits, in prefill
    and in decode; with the gates at their init value of zero it gives the
    same ones."""
    _, ta = _archs("float32")
    model = LM(ta, device="cpu", recent_window=4)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(2, ta.vocab, (2, 10)))
    fronts = [torch.from_numpy(rng.standard_normal((2, 16, 64))
                               .astype(np.float32)) for _ in range(2)]

    def run(p, fr):
        logits, cache = model.prefill(p, toks, frontend=fr)
        step, _ = model.decode_step(p, cache, logits.argmax(-1))
        return logits, step
    a, b = run(params, fronts[0]), run(params, fronts[1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for g in ("gate_attn", "gate_mlp"):
        params["seg0"]["cross"][g].fill_(GATE)
    a, b = run(params, fronts[0]), run(params, fronts[1])
    for x, y in zip(a, b):
        assert (x - y).abs().max() > 1e-2 * x.abs().max()


def test_vlm_prefill_needs_a_frontend():
    _, ta = _archs("float32")
    model = LM(ta, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frontend"):
        model.prefill(params, torch.zeros((1, 4), dtype=torch.long))
