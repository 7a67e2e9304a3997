"""The port's model code against the reference's on the same inputs: the
building blocks (dense and Mamba-2) against their jnp versions, the
parameter layout and conversion, and ``LM.prefill`` logits and K/V against
the JAX ``LM.prefill`` on weights converted by ``repro_torch.convert``.
Generation (prefill + decode) is in test_torch_generation.py."""
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
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models import common, mamba2  # noqa: E402
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
    kw = {"n_layers": 2, "d_model": 64, "vocab": 128, **kw}
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
    tl, tcache = LM(ta, device="cpu").prefill(tp, torch.from_numpy(toks),
                                              logit_pos=20)
    tk, tv = tcache[0]["k_big"], tcache[0]["v_big"]
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
    for name, n_layers in (("granite-3-8b", 2), ("llama2-7b", 2),
                           ("qwen2.5-32b", 2), ("mamba2-1.3b", 2),
                           ("zamba2-7b", 5)):
        ja, ta = _pair(name, "bfloat16", n_layers=n_layers)
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


def test_init_draws_a_log_in_fp32():
    """A_log = log U[1, 16] in fp32 whatever the param dtype, D ones."""
    _, ta = _pair("zamba2-7b", "bfloat16", n_layers=5)
    params = LM(ta, device="cpu").init(torch.Generator().manual_seed(0))
    for seg in (params["seg0"]["mamba"], params["seg1"]):
        a_log = seg["A_log"]
        assert a_log.dtype == torch.float32
        assert torch.all(a_log >= 0) and torch.all(a_log <= math.log(16.0))
        assert seg["D"].dtype == torch.bfloat16 and torch.all(seg["D"] == 1)
    assert params["seg0"]["attn"]["wq"].dim() == 2      # shared, unstacked


def test_convert_hybrid_tree_key_for_key():
    """The nested hybrid tree, fp32 A_log among bf16 leaves, converts key
    for key and value for value."""
    ja, _ = _pair("zamba2-7b", "bfloat16", n_layers=5)
    jp = jax.tree.map(np.asarray, JaxLM(ja).init(jax.random.key(0)))
    tp = params_from_jax_numpy(jp)

    def walk(j, t, path):
        assert sorted(j) == sorted(t), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], path + "/" + k)
                continue
            want = torch.bfloat16 if j[k].dtype.name == "bfloat16" \
                else torch.float32
            assert t[k].dtype == want and tuple(t[k].shape) == j[k].shape
            np.testing.assert_array_equal(t[k].float().numpy(),
                                          np.asarray(j[k], np.float32))
    walk(jp, tp, "")
    assert tp["seg0"]["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gated_rmsnorm_matches(dtype):
    rng = np.random.default_rng(8)
    y, z = (jnp.asarray(rng.standard_normal((2, 5, 64)), dtype)
            for _ in range(2))
    w = jnp.asarray(rng.standard_normal((64,)), dtype)
    want = jax_mamba2._gated_rmsnorm(y, z, w, 1e-5)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = mamba2._gated_rmsnorm(_t(y, tdt), _t(z, tdt), _t(w, tdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == jnp.float32 else BF16))


@pytest.mark.parametrize("s", [1, 2, 9, 40])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_causal_depthwise_conv_matches(s, dtype):
    rng = np.random.default_rng(9)
    seq = jnp.asarray(rng.standard_normal((2, s, 24)), dtype)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.5, dtype)
    b = jnp.asarray(rng.standard_normal((24,)), dtype)
    want = jax_mamba2._causal_depthwise_conv(seq, w, b, None)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = mamba2._causal_depthwise_conv(_t(seq, tdt), _t(w, tdt),
                                        _t(b, tdt))
    assert got.shape == want.shape and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == jnp.float32 else BF16))


@pytest.mark.parametrize("s", [2, 40, 64])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_mamba_block_full_matches_jax(s, param_dtype):
    """Output and cache of one Mamba-2 block on layer 0's converted weights;
    S = 40 is not a multiple of the reduced chunk (32), S = 2 is shorter
    than the conv window."""
    ja, ta = _pair("mamba2-1.3b", param_dtype)
    jp = JaxLM(ja).init(jax.random.key(0))
    jl = jax.tree.map(lambda t: t[0], jp["seg0"])
    tl = params_from_jax_numpy(jax.tree.map(np.asarray, jl))
    jdt = jnp.float32 if param_dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(np.random.default_rng(10).standard_normal(
        (2, s, ja.d_model)), jdt)
    want, wc = jax_mamba2.mamba_block_full(x, jl, ja, return_cache=True)
    got, gc = mamba2.mamba_block_full(_t(x, LM(ta, device="cpu").dtype), tl,
                                      ta, return_cache=True)
    _close_model(got, want, param_dtype)
    for name in ("ssm_state", "conv_x", "conv_bc"):
        g, w = getattr(gc, name), getattr(wc, name)
        assert g.shape == w.shape, name
        assert g.dtype == (torch.float32 if name == "ssm_state"
                           else torch.bfloat16), name
        if name == "ssm_state" and param_dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-3, atol=1e-3)
        else:
            _close_model(g, w, "bfloat16")
