"""The port's generation path (``LM.prefill`` -> ``LM.decode_step`` ->
``LM.maybe_flush``, the staged-cache decode) against the JAX ``LM`` on
converted weights, for an SSM, a hybrid and a dense arch; twins of the
reference's decode-consistency and flush tests; and prefill + decode smoke
runs over every assigned arch (the VLM's cross-attention gates set
nonzero, and an fp32 frontend as the reference's smoke test feeds it)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    attend_partial as jax_attend, merge_partials as jax_merge)
from repro.models.attention import (  # noqa: E402
    make_attn_cache as jax_make_attn_cache)
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.models.model import ExecConfig  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, Family,  # noqa: E402
                                 get_arch, reduced)
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import (attend_partial,  # noqa: E402
                                                  merge_partials)
from repro_torch.models.attention import make_attn_cache  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from test_torch_models import _close_model  # noqa: E402

PORTED = (Family.DENSE, Family.AUDIO, Family.MOE, Family.SSM,
          Family.HYBRID, Family.VLM)
SMOKE_ARCHS = [n for n in ASSIGNED_ARCHS if get_arch(n).family in PORTED]
GEN_ARCHS = [("mamba2-1.3b", 2), ("zamba2-7b", 3), ("granite-3-8b", 2)]


def _leaves(c, path=""):
    """(path, leaf) pairs of a cache, JAX's or the port's (lists, dicts and
    the MambaCache dataclass alike)."""
    if isinstance(c, (list, tuple)):
        for i, v in enumerate(c):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(c, dict):
        for k in sorted(c):
            yield from _leaves(c[k], f"{path}/{k}")
    elif dataclasses.is_dataclass(c):
        for f in dataclasses.fields(c):
            yield from _leaves(getattr(c, f.name), f"{path}.{f.name}")
    else:
        yield path, c


def _check_cache(tc, jc, param_dtype):
    got, want = dict(_leaves(tc)), dict(_leaves(jc))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(g, int):                       # big_len / rec_len
            assert g == int(np.asarray(w)), path
            continue
        assert tuple(g.shape) == w.shape, path
        if path.endswith("ssm_state") and param_dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                       atol=1e-3, err_msg=path)
        elif g.dtype == torch.bfloat16:
            _close_model(g, w, "bfloat16")
        else:
            _close_model(g, w, param_dtype)


def _models(name, n_layers, param_dtype, window):
    kw = dict(n_layers=n_layers, d_model=64, vocab=128)
    ja = dataclasses.replace(jax_reduced(jax_get_arch(name), **kw),
                             param_dtype=param_dtype)
    ta = dataclasses.replace(reduced(get_arch(name), **kw),
                             param_dtype=param_dtype)
    jm = JaxLM(ja, exec_cfg=ExecConfig(recent_window=window))
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, LM(ta, device="cpu", recent_window=window), tp


@pytest.mark.parametrize("name,n_layers", GEN_ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_generation_matches_jax(name, n_layers, param_dtype):
    """Prefill logits and every cache leaf, then decode_step logits and
    caches over 6 steps with a flush after the 4th (recent window 4), on
    converted weights. The prompt (40) is not a multiple of the reduced
    SSD chunk (32)."""
    jm, jp, tm, tp = _models(name, n_layers, param_dtype, window=4)
    rng = np.random.default_rng(3)
    toks = rng.integers(2, jm.arch.vocab, (2, 40))
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), s_max=48)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), s_max=48)
    assert tl.dtype == torch.float32 and tl.shape == (2, jm.arch.vocab)
    _close_model(tl, jl, param_dtype)
    _check_cache(tc, jc, param_dtype)
    for i, tok in enumerate(rng.integers(2, jm.arch.vocab, (6, 2))):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_model(tl, jl, param_dtype)
        if i == 3:
            jc, tc = jm.maybe_flush(jc), tm.maybe_flush(tc)
    _check_cache(tc, jc, param_dtype)


def test_audio_prefill_from_embeds_matches_jax():
    """Family.AUDIO takes frame embeddings and adds sinusoidal positions,
    in prefill and (from the cache length) in decode."""
    jm, jp, tm, tp = _models("musicgen-medium", 2, "float32", window=8)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 12, 64)).astype(np.float32)
    jl, jc = jm.prefill(jp, embeds=jnp.asarray(emb), s_max=16)
    tl, tc = tm.prefill(tp, embeds=torch.from_numpy(emb), s_max=16)
    _close_model(tl, jl, "float32")
    tok = np.array([5, 9])
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
    tl, _ = tm.decode_step(tp, tc, torch.from_numpy(tok))
    _close_model(tl, jl, "float32")


def test_init_cache_matches_jax_layout():
    for name, n_layers in GEN_ARCHS:
        jm, _, tm, _ = _models(name, n_layers, "bfloat16", window=8)
        want = {p: (tuple(np.shape(v)), str(np.asarray(v).dtype))
                for p, v in _leaves(jm.init_cache(2, 24))}
        got = dict(_leaves(tm.init_cache(2, 24)))
        assert sorted(got) == sorted(want), name
        for p, v in got.items():
            if isinstance(v, int):
                assert v == 0
            else:
                assert (tuple(v.shape), str(v.dtype).replace("torch.", "")) \
                    == want[p], (name, p)
    want = dict(_leaves(jax_make_attn_cache(2, 24, 4, 16, window=8)))
    got = dict(_leaves(make_attn_cache(2, 24, 4, 16, window=8)))
    assert sorted(got) == sorted(want)
    for p, v in got.items():
        if isinstance(v, int):
            assert v == int(np.asarray(want[p])) == 0, p
        else:
            assert tuple(v.shape) == want[p].shape and \
                v.dtype == torch.bfloat16 and not v.any(), p


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_attend_partial_merge_matches_jax(dtype):
    """Two partial states (one segment fully masked for one sequence)
    merged, against the jnp building blocks."""
    rng = np.random.default_rng(5)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16

    def pair(shape):
        j = jnp.asarray(rng.standard_normal(shape), dtype)
        return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)
    qj, qt = pair((2, 8, 32))
    k1j, k1t = pair((2, 24, 2, 32))
    v1j, v1t = pair((2, 24, 2, 32))
    k2j, k2t = pair((2, 6, 2, 32))
    v2j, v2t = pair((2, 6, 2, 32))
    valid1 = np.arange(24)[None] < np.array([[0], [17]])
    valid2 = np.arange(6)[None] <= np.array([[2], [4]])
    want = jax_merge([jax_attend(qj, k1j, v1j, jnp.asarray(valid1)),
                      jax_attend(qj, k2j, v2j, jnp.asarray(valid2))])
    got = merge_partials([
        attend_partial(qt, k1t, v1t, torch.from_numpy(valid1)),
        attend_partial(qt, k2t, v2t, torch.from_numpy(valid2))])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _teacher_forced(name, seed, s_max_pad):
    """Logits of prefill over all S tokens, and of prefill over the first
    8 then decode of the rest (the port's twin of the reference tests)."""
    arch = reduced(get_arch(name))
    model = LM(arch, device="cpu", recent_window=8)
    params = model.init(torch.Generator().manual_seed(seed))
    b, s, cut = 2, 12, 8
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, arch.vocab, (b, s)))
    s_max = s + s_max_pad if s_max_pad else None
    full, _ = model.prefill(params, toks, s_max=s_max)
    logits, cache = model.prefill(params, toks[:, :cut], s_max=s_max)
    for t in range(cut, s):
        logits, cache = model.decode_step(params, cache, toks[:, t])
    return logits, full


def test_decode_matches_prefill_dense():
    """Teacher forcing: decoding token t reproduces the prefill logits at
    position t (dense arch)."""
    logits, full = _teacher_forced("granite-3-8b", 2, s_max_pad=4)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=5e-2,
                               atol=1e-1)


def test_decode_matches_prefill_ssm():
    logits, full = _teacher_forced("mamba2-1.3b", 4, s_max_pad=0)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=5e-2,
                               atol=1e-1)


def test_decode_matches_prefill_hybrid():
    logits, full = _teacher_forced("zamba2-7b", 6, s_max_pad=4)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=5e-2,
                               atol=1e-1)


def test_flush_preserves_decode():
    """Flushing recent -> big must not change subsequent logits."""
    arch = reduced(get_arch("mistral-nemo-12b"))
    model = LM(arch, device="cpu", recent_window=8)
    params = model.init(torch.Generator().manual_seed(6))
    b, s = 2, 8
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, arch.vocab, (b, s)))
    _, cache = model.prefill(params, toks, s_max=32)
    tok = torch.zeros((b,), dtype=torch.long)
    for _ in range(4):
        _, cache = model.decode_step(params, cache, tok)
    flushed = model.maybe_flush(cache)
    assert flushed[0]["big_len"] == s + 4 and flushed[0]["rec_len"] == 0
    l_a, _ = model.decode_step(params, cache, tok)
    l_b, _ = model.decode_step(params, flushed, tok)
    np.testing.assert_allclose(l_a.numpy(), l_b.numpy(), rtol=5e-2,
                               atol=1e-1)


@pytest.mark.parametrize("name", SMOKE_ARCHS)
def test_prefill_decode_smoke(name):
    """Reduced config: prefill, then 3 greedy decode steps; shapes and
    finiteness (the port's twin of the reference smoke test)."""
    arch = reduced(get_arch(name))
    model = LM(arch, device="cpu", recent_window=8)
    params = model.init(torch.Generator().manual_seed(1))
    b, s = 2, 16
    rng = np.random.default_rng(0)
    kw = {}
    if arch.family == Family.VLM:
        # an fp32 frontend, as the reference's smoke test feeds it, and the
        # cross layers' gates (zero at init) set so that they count
        kw["frontend"] = torch.from_numpy(rng.standard_normal(
            (b, arch.n_frontend_tokens, arch.d_model)).astype(np.float32))
        for g in ("gate_attn", "gate_mlp"):
            params["seg0"]["cross"][g].fill_(0.5)
    if arch.family == Family.AUDIO:
        emb = torch.from_numpy(rng.standard_normal((b, s, arch.d_model))
                               .astype(np.float32))
        logits, cache = model.prefill(params, embeds=emb, s_max=s + 8)
    else:
        toks = torch.from_numpy(rng.integers(0, arch.vocab, (b, s)))
        logits, cache = model.prefill(params, toks, s_max=s + 8, **kw)
    assert logits.shape == (b, arch.vocab)
    assert torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    for i in range(3):
        logits, cache = model.decode_step(params, cache, tok)
        assert logits.shape == (b, arch.vocab)
        assert torch.isfinite(logits).all(), (name, i)
        tok = logits.argmax(-1)
