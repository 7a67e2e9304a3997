"""The port's model code against the reference's on the same inputs: the
building blocks against their jnp versions, and ``LM.prefill`` logits and
K/V against the JAX ``LM.prefill`` on weights converted by
``repro_torch.convert``."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _close_model(got, want, param_dtype):
    """fp32: 1e-5. bf16: 2e-2, absolute part relative to the tensor's
    largest value. XLA and PyTorch sum a bf16 matmul's fp32 products in
    different orders, so a rare output rounds to the other neighbour; over
    two layers that flip reaches other entries as an absolute error of a
    few ulps of the largest terms (rope's x1*cos - x2*sin cancels to
    values far smaller than its terms)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if param_dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("pos_shape", [(12,), (3, 12)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rope_matches(pos_shape, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 12, 4, 32)), dtype)
    pos = rng.integers(0, 4096, pos_shape).astype(np.int32)
    want = jax_common.rope(x, jnp.asarray(pos), 10000.0)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = common.rope(_t(x, tdt), torch.from_numpy(pos), 10000.0)
    tol = F32 if dtype == jnp.float32 else BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("pos_shape", [(16,), (2, 16)])
def test_sinusoidal_pos_matches(pos_shape):
    pos = np.arange(int(np.prod(pos_shape)), dtype=np.int32) \
        .reshape(pos_shape) * 37
    want = jax_common.sinusoidal_pos(jnp.asarray(pos), 64)
    got = common.sinusoidal_pos(torch.from_numpy(pos), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches(act):
    rng = np.random.default_rng(1)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32) * 0.2
                 for s in ((5, 32), (32, 48), (32, 48)))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    want = jax_common.gated_mlp(*map(jnp.asarray, (x, wg, wu, wd)), act)
    got = common.gated_mlp(*map(torch.from_numpy, (x, wg, wu, wd)), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 7, 64)), dtype)
    w = jnp.asarray(rng.standard_normal((64,)), dtype)
    want = jax_common.rms_norm(x, w, 1e-5)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = common.rms_norm(_t(x, tdt), _t(w, tdt), 1e-5)
    tol = F32 if dtype == jnp.float32 else BF16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _pair(name, param_dtype, **kw):
    kw = dict(n_layers=2, d_model=64, vocab=128, **kw)
    ja = dataclasses.replace(jax_reduced(jax_get_arch(name), **kw),
                             param_dtype=param_dtype)
    ta = dataclasses.replace(reduced(get_arch(name), **kw),
                             param_dtype=param_dtype)
    return ja, ta


@pytest.mark.parametrize("name", ["granite-3-8b", "llama2-7b"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(name, param_dtype):
    """Logits at logit_pos and every layer's K/V, on converted weights."""
    ja, ta = _pair(name, param_dtype)
    jm = JaxLM(ja)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(2, ja.vocab, (2, 32))
    jl, jcache = jm.prefill(jp, tokens=jnp.asarray(toks), logit_pos=20)
    tl, (tk, tv) = LM(ta, device="cpu").prefill(tp, torch.from_numpy(toks),
                                                logit_pos=20)
    assert tl.dtype == torch.float32 and tl.shape == (2, ja.vocab)
    _close_model(tl, jl, param_dtype)
    for got, key in ((tk, "k_big"), (tv, "v_big")):
        want = jcache[0][key]
        assert got.shape == want.shape          # (L, B, S, Hkv, hd)
        assert got.dtype == (torch.float32 if param_dtype == "float32"
                             else torch.bfloat16)
        _close_model(got, want, param_dtype)


def test_param_template_matches_jax_layout():
    """Same leaf names and shapes as the reference (stacked under seg0)."""
    for name in ("granite-3-8b", "llama2-7b", "qwen2.5-32b"):
        ja, ta = _pair(name, "bfloat16")
        jt = JaxLM(ja).param_template()
        tt = LM(ta, device="cpu").param_template()

        def shapes(t, idx):
            return {k: shapes(v, idx) if isinstance(v, dict) else v[idx]
                    for k, v in t.items()}
        assert shapes(tt, 0) == shapes(jt, 0), name


def test_init_follows_reference_scales():
    _, ta = _pair("qwen2.5-32b", "bfloat16")          # has qkv biases
    params = LM(ta, device="cpu").init(torch.Generator().manual_seed(0))
    seg = params["seg0"]
    assert params["embed"].dtype == torch.bfloat16
    assert torch.all(seg["ln1"] == 1) and torch.all(params["final_ln"] == 1)
    assert torch.all(seg["bq"] == 0)
    std = seg["wq"].float().std().item()
    assert abs(std - 1 / math.sqrt(ta.d_model)) < 0.1 / math.sqrt(ta.d_model)
    again = LM(ta, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(again["seg0"]["wd"], seg["wd"])


def test_lm_rejects_unported_families():
    with pytest.raises(NotImplementedError):
        LM(reduced(get_arch("mamba2-1.3b")), device="cpu")
