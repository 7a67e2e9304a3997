"""The port's training (``repro_torch.training``, ``LM.train_loss``, the
launcher and the example) against the reference's on the same inputs:

- ``batch_at_step`` bit for bit; ``schedule`` and ``apply_adamw`` within
  1e-6; ``compress_int8`` and error feedback bit for bit;
- ``train_loss`` and every leaf's gradient against
  ``jax.value_and_grad(LM.train_loss)`` in fp32 for seven reduced archs
  (rtol 1e-4, atol 1e-5), bf16 losses within 2e-2 of their value;
  ``loss_and_grads`` over 2 microbatches and 3 ``make_train_step`` steps
  against JAX's; remat changes no gradient;
- checkpoints cross between the packages both ways, leaf for leaf;
- the closed-form backwards of kernels B2 and B3 (``flash_attention_bwd``,
  ``rmsnorm_bwd``, the plain versions of the backward kernels that run on
  the card inside the kernels' autograd Functions) against ``jax.vjp`` of
  the reference's oracles; B2's also from the logsumexp the forward
  writes, and B3's dw also as the backward kernel's two passes (per-CTA
  partials, then their column sum);
- twins of ``tests/test_training.py`` and of
  ``tests/test_models_smoke.py::test_train_step_smoke``, the launcher's
  ``--smoke`` run and the example's resume.

Weights are built by the JAX ``LM`` and converted with
``params_from_jax_numpy``; batches come from numpy seeds, so both packages
see the same numbers."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref)
from repro.kernels.rmsnorm.ref import (  # noqa: E402
    rmsnorm_ref as jax_rmsnorm_ref)
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.models.model import ExecConfig  # noqa: E402
from repro import training as jt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_ref)
from repro_torch.kernels.rmsnorm import (bwd_ctas, rmsnorm_bwd,  # noqa: E402
                                         rmsnorm_dw_partials)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch import training as tt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

GRAD = dict(rtol=1e-4, atol=1e-5)          # fp32 losses and gradients
# fp32 params after AdamW steps: the update divides each element's first
# moment by the root of its second, so an element whose gradient is near 0
# turns the fp32 noise of its gradient into an update difference of up to
# lr; 5e-5 is 0.05 lr at the lr of 1e-3 these steps take
PARAMS = dict(rtol=1e-4, atol=5e-5)
VLM_GATE = 0.5
# the seven archs whose loss and gradients are held against JAX's, one of
# each family (granite: tied embeddings and GQA)
PARITY_ARCHS = ("granite-3-8b", "llama2-7b", "qwen2-moe-a2.7b",
                "mamba2-1.3b", "zamba2-7b", "llama-3.2-vision-90b",
                "musicgen-medium")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _leaves(tree):
    """(key, leaf) in sorted key order, for dicts of either package."""
    if isinstance(tree, dict):
        return [(f"{k}/{kk}" if kk else k, v) for k in sorted(tree)
                for kk, v in _leaves(tree[k])]
    return [("", tree)]


def _archs(name, param_dtype="float32"):
    n = 4 if name == "llama-3.2-vision-90b" else 2
    ja = dataclasses.replace(jax_reduced(jax_get_arch(name), n_layers=n),
                             param_dtype=param_dtype)
    ta = dataclasses.replace(reduced(get_arch(name), n_layers=n),
                             param_dtype=param_dtype)
    return ja, ta


def _jax_params(jm, seed=0):
    jp = jm.init(jax.random.key(seed))
    if "cross" in jp.get("seg0", {}):      # VLM: gates 0 at init
        for g in ("gate_attn", "gate_mlp"):
            jp["seg0"]["cross"][g] = jnp.full_like(jp["seg0"]["cross"][g],
                                                   VLM_GATE)
    return jp


def _to_port(jp):
    return params_from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(ta, b=2, s=16, step=0):
    """A batch of the port's pipeline and the same arrays for JAX."""
    dcfg = tt.DataConfig(vocab=ta.vocab, seq_len=s, global_batch=b,
                         family=ta.family.value, d_model=ta.d_model,
                         n_frontend_tokens=ta.n_frontend_tokens)
    tb = tt.batch_at_step(dcfg, step)
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def _assert_tree_close(got, want, **tol):
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# data, schedule, optimizer, compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("family", ["dense", "audio", "vlm"])
def test_batch_at_step_bit_for_bit(family, step):
    kw = dict(vocab=300, seq_len=24, global_batch=3, seed=5, family=family,
              d_model=32, n_frontend_tokens=7)
    want = jt.batch_at_step(jt.DataConfig(**kw), step)
    got = tt.batch_at_step(tt.DataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if k in ("embeds", "frontend")
                                else torch.int64), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (100, 10000)])
def test_schedule_matches(warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, 3, 5, 9, 10, 11, 150, 10000):
        want = float(jopt.schedule(jopt.AdamWConfig(**kw), jnp.int32(step)))
        got = float(topt.schedule(topt.AdamWConfig(**kw), step))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _grad_trees(rng, params_np):
    """Random gradients shaped like the params, for both packages."""
    g = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
         for k, v in params_np.items()}
    return g, {k: torch.from_numpy(v) for k, v in g.items()}


@pytest.mark.parametrize("compression", [False, True])
def test_apply_adamw_matches_jax_over_3_steps(compression):
    rng = np.random.default_rng(0)
    p_np = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "norm": rng.standard_normal((5,)).astype(np.float32),
            "stack": rng.standard_normal((2, 5)).astype(np.float32)}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p_np.items()}
    js = jopt.init_opt_state(jp, compression=compression)
    ts = topt.init_opt_state(tp, compression=compression)
    for _ in range(3):
        gj, gt = _grad_trees(rng, p_np)
        gj = {k: jnp.asarray(v) for k, v in gj.items()}
        if compression:
            gj, ef = jopt.compressed_grads_with_ef(gj, js.ef)
            js = js._replace(ef=ef)
            gt, ef = topt.compressed_grads_with_ef(gt, ts.ef)
            ts = ts._replace(ef=ef)
        jp, js, jm = jopt.apply_adamw(jopt.AdamWConfig(**cfg_kw), gj, js, jp)
        tp, ts, tm = topt.apply_adamw(topt.AdamWConfig(**cfg_kw), gt, ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for a, b in ((ts.master, js.master), (ts.mu, js.mu), (ts.nu, js.nu)):
        _assert_tree_close(a, b, rtol=1e-6, atol=1e-6)
    _assert_tree_close(tp, jp, rtol=1e-6, atol=1e-6)
    assert all(t.dtype == torch.bfloat16 for t in tp.values())
    if compression:
        _assert_tree_close(ts.ef, js.ef, rtol=1e-6, atol=1e-6)


def test_compress_int8_bit_for_bit():
    rng = np.random.default_rng(1)
    for shape, scale in (((64, 32), 1.0), ((7,), 1e-3), ((3, 5, 4), 50.0)):
        g = (rng.standard_normal(shape) * scale).astype(np.float32)
        # exact halves of the step: rounding half to even on both sides
        g.flat[0] = 0.0
        qj, sj = jopt.compress_int8(jnp.asarray(g))
        qt, st = topt.compress_int8(torch.from_numpy(g))
        assert qt.dtype == torch.int8
        assert float(st) == float(sj)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(
            topt.decompress_int8(qt, st).numpy(),
            np.asarray(jopt.decompress_int8(qj, sj)))
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    qj, _ = jopt.compress_int8(jnp.asarray(half))
    qt, _ = topt.compress_int8(torch.from_numpy(half))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_compressed_grads_with_ef_bit_for_bit():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
         "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    ej = jax.tree.map(lambda v: jnp.zeros(v.shape, jnp.float32), g)
    et = {"a": torch.zeros(16, 8), "b": {"c": torch.zeros(5)}}
    for _ in range(4):
        dj, ej = jopt.compressed_grads_with_ef(
            jax.tree.map(jnp.asarray, g), ej)
        dt, et = topt.compressed_grads_with_ef(
            {"a": torch.from_numpy(g["a"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, et)
        for (k, a), (_, b) in zip(_leaves(dt) + _leaves(et),
                                  _leaves(dj) + _leaves(ej)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), k)


# ---------------------------------------------------------------------------
# train_loss and every leaf's gradient against jax.value_and_grad
# ---------------------------------------------------------------------------
def _jax_value_and_grad(jm, jp, jb):
    (loss, metrics), grads = jax.value_and_grad(jm.train_loss,
                                                has_aux=True)(jp, jb)
    return loss, metrics, grads


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_train_loss_and_grads_match_jax(name):
    ja, ta = _archs(name)
    jm = JaxLM(ja, exec_cfg=ExecConfig(loss_chunk=8))
    jp = _jax_params(jm)
    tb, jb = _batches(ta)
    jloss, jmet, jgrads = _jax_value_and_grad(jm, jp, jb)
    model = LM(ta, device="cpu", loss_chunk=8)
    loss, grads, met = tts.loss_and_grads(model, _to_port(jp), tb)
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD)
    for k in ("xent", "lb_loss", "moe_drops"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **GRAD)
    _assert_tree_close(grads, jgrads, **GRAD)


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_train_loss_bf16_matches_jax(name):
    """bf16 weights: the losses within 2e-2 of their value (XLA and
    PyTorch round bf16 matmuls differently, ROADMAP C5). The MoE arch is
    held against the reference's layer-by-layer run (ROADMAP C9)."""
    ja, ta = _archs(name, "bfloat16")
    jm = JaxLM(ja, exec_cfg=ExecConfig(
        loss_chunk=8, scan_layers=ja.moe is None))
    jp = _jax_params(jm)
    tb, jb = _batches(ta)
    want = float(jm.train_loss(jp, jb)[0])
    got, _ = LM(ta, device="cpu", loss_chunk=8).train_loss(_to_port(jp), tb)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=2e-2)


def test_loss_and_grads_two_microbatches_match_jax():
    ja, ta = _archs("granite-3-8b")
    jm = JaxLM(ja, exec_cfg=ExecConfig(loss_chunk=8))
    jp = _jax_params(jm)
    tb, jb = _batches(ta, b=4)
    jl, jg, _ = jts.loss_and_grads(jm, jp, jb, microbatches=2)
    tl, tg, _ = tts.loss_and_grads(LM(ta, device="cpu", loss_chunk=8),
                                   _to_port(jp), tb, microbatches=2)
    np.testing.assert_allclose(float(tl), float(jl), **GRAD)
    assert all(t.dtype == torch.float32 for t in topt.tree_leaves(tg))
    _assert_tree_close(tg, jg, **GRAD)


@pytest.mark.parametrize("compression", [False, True])
def test_three_train_steps_match_jax(compression):
    ja, ta = _archs("granite-3-8b")
    jm = JaxLM(ja, exec_cfg=ExecConfig(loss_chunk=8))
    jp = _jax_params(jm)
    cfg_kw = dict(microbatches=2, grad_compression=compression)
    adamw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jcfg = jt.TrainConfig(adamw=jopt.AdamWConfig(**adamw), **cfg_kw)
    tcfg = tt.TrainConfig(adamw=topt.AdamWConfig(**adamw), **cfg_kw)
    jo = jopt.init_opt_state(jp, compression=compression)
    tp = _to_port(jp)
    to = topt.init_opt_state(tp, compression=compression)
    jstep = jax.jit(jt.make_train_step(jm, jcfg))
    tstep = tt.make_train_step(LM(ta, device="cpu", loss_chunk=8), tcfg)
    for i in range(3):
        tb, jb = _batches(ta, b=4, step=i)
        jp, jo, jm_ = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]), **GRAD)
    _assert_tree_close(tp, jp, **PARAMS)
    _assert_tree_close(to.master, jo.master, **PARAMS)


def test_train_step_does_not_update_its_inputs():
    _, ta = _archs("granite-3-8b")
    model = LM(ta, device="cpu", loss_chunk=8)
    cfg = tt.TrainConfig(adamw=topt.AdamWConfig(lr=1e-2, warmup_steps=1))
    params, opt = tt.init_train_state(model, torch.Generator().manual_seed(0),
                                      cfg)
    before = [t.clone() for t in topt.tree_leaves(params)
              + topt.tree_leaves(opt.master) + [opt.step]]
    new_p, new_o, _ = tt.make_train_step(model, cfg)(
        params, opt, _batches(ta)[0])
    after = topt.tree_leaves(params) + topt.tree_leaves(opt.master) \
        + [opt.step]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(new_o.step) == 1 and not all(
        torch.equal(a, b) for a, b in zip(topt.tree_leaves(new_p),
                                          topt.tree_leaves(params)))


@pytest.mark.parametrize("name", ["granite-3-8b", "zamba2-7b"])
def test_remat_gives_the_same_gradients(name):
    _, ta = _archs(name)
    params = LM(ta, device="cpu").init(torch.Generator().manual_seed(3))
    tb, _ = _batches(ta)
    outs = [tts.loss_and_grads(LM(ta, device="cpu", loss_chunk=8,
                                  remat=remat), params, tb)
            for remat in (False, True)]
    assert float(outs[0][0]) == float(outs[1][0])
    for (k, a), (_, b) in zip(_leaves(outs[0][1]), _leaves(outs[1][1])):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# checkpoints cross between the packages
# ---------------------------------------------------------------------------
def _trained_pair(compression=True):
    """JAX params and opt state after one step, and the port's tree of the
    same structure built from them."""
    ja, ta = _archs("granite-3-8b", "bfloat16")
    jm = JaxLM(ja, exec_cfg=ExecConfig(loss_chunk=8))
    cfg = jt.TrainConfig(adamw=jopt.AdamWConfig(lr=1e-2, warmup_steps=1),
                         grad_compression=compression)
    jp, jo = jt.init_train_state(jm, jax.random.key(0), cfg)
    jp, jo, _ = jax.jit(jt.make_train_step(jm, cfg))(
        jp, jo, _batches(ta)[1])
    tp = _to_port(jp)
    return {"params": jp, "opt": jo}, {
        "params": tp, "opt": topt.init_opt_state(tp, compression)}


def _assert_same_leaves(port_tree, jax_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    from repro_torch.training.checkpoint import _flatten
    got = _flatten(port_tree)
    assert len(got) == len(flat)
    for (key, t), (_, j) in zip(got, flat):
        j = np.asarray(j)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
        np.testing.assert_array_equal(_np(t), j.astype(np.float32), key)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jtree, like = _trained_pair()
    jt.save(str(tmp_path), 1, jtree, extra={"data_step": 1})
    assert tt.latest_step(str(tmp_path)) == 1
    tree, extra = tt.load(str(tmp_path), 1, like)
    assert extra == {"data_step": 1}
    assert isinstance(tree["opt"], topt.OptState)
    _assert_same_leaves(tree, jtree)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port saves a tree it holds (here loaded from JAX's checkpoint,
    so the values are known): same manifest as JAX's, and JAX loads it
    leaf for leaf."""
    jtree, like = _trained_pair()
    jt.save(str(tmp_path / "jax"), 1, jtree, extra={"data_step": 1})
    tree, _ = tt.load(str(tmp_path / "jax"), 1, like)
    tt.save(str(tmp_path / "port"), 1, tree, extra={"data_step": 1})
    manifest = json.loads((tmp_path / "port" / "step_00000001"
                           / "manifest.json").read_text())
    want = json.loads((tmp_path / "jax" / "step_00000001"
                       / "manifest.json").read_text())
    assert manifest == want
    back, extra = jt.load(str(tmp_path / "port"), 1, jtree)
    assert extra == {"data_step": 1}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the backwards of kernels B2 and B3 against jax.vjp of the oracles
# ---------------------------------------------------------------------------
FLASH_BWD_CASES = [
    # b, sq, skv, hq, hkv, d, causal, q_offset, kv_len, kv_chunk
    (2, 32, 32, 4, 2, 16, True, 0, None, 256),      # causal, GQA 4/2
    (1, 24, 40, 4, 4, 16, False, 0, None, 16),      # full; 40 % 16: dense
    (2, 16, 48, 4, 2, 32, False, 0, None, 16),      # full, chunked
    (2, 8, 40, 4, 2, 16, True, 32, None, 16),       # causal with q_offset
    (2, 8, 24, 4, 2, 16, True, 16, [0, 20], 8),     # a row sees no key
    (2, 12, 12, 4, 1, 16, False, 0, [12, 0], 4),    # full, dead batch
]


def _flash_inputs(rng, case, dtype):
    b, sq, skv, hq, hkv, d = case[:6]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


def _close_grad(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, err_msg=what, **GRAD)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_elems", [1 << 26, 2048])
def test_flash_attention_bwd_matches_jax_vjp(case, dtype, block_elems):
    """``block_elems`` 2048 cuts the query rows into chunks of a few rows,
    so causal chunks skip the keys no row of theirs sees."""
    _, _, _, _, _, _, causal, q_offset, kv_len, kv_chunk = case
    rng = np.random.default_rng(len(str(case)))
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _flash_inputs(rng, case, dtype)
    klj = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    klt = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=klj,
        kv_chunk=kv_chunk), qj, kj, vj)
    want = vjp(doj)
    out = flash_attention_ref(qt, kt, vt, causal=causal, q_offset=q_offset,
                              kv_len=klt, kv_chunk=kv_chunk)
    got = flash_attention_bwd(qt, kt, vt, out, dot, causal=causal,
                              q_offset=q_offset, kv_len=klt,
                              block_elems=block_elems)
    for name, g, w, t in zip("qkv", got, want, (qt, kt, vt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close_grad(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_from_lse_matches_jax_vjp(case, dtype):
    """Given the forward's logsumexp (``return_lse``, what the forward
    kernel writes for the backward kernel), at the tolerances of the test
    above."""
    _, _, _, _, _, _, causal, q_offset, kv_len, kv_chunk = case
    rng = np.random.default_rng(len(str(case)))
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _flash_inputs(rng, case, dtype)
    klj = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    klt = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=klj,
        kv_chunk=kv_chunk), qj, kj, vj)
    want = vjp(doj)
    out, lse = flash_attention_ref(qt, kt, vt, causal=causal,
                                   q_offset=q_offset, kv_len=klt,
                                   kv_chunk=kv_chunk, return_lse=True)
    got = flash_attention_bwd(qt, kt, vt, out, dot, causal=causal,
                              q_offset=q_offset, kv_len=klt, lse=lse)
    for name, g, w, t in zip("qkv", got, want, (qt, kt, vt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close_grad(g, w, dtype, f"d{name}")


def test_flash_attention_bwd_matches_autograd_of_the_plain_version():
    """The same gradients autograd takes of the plain version, which the
    card's checks hold the kernel's Function against."""
    rng = np.random.default_rng(9)
    _, (q, k, v, do) = _flash_inputs(rng, FLASH_BWD_CASES[0],
                                     torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention_ref(q, k, v, causal=True)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                              out.detach(), do, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 64), (2, 8, 128), (3, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_bwd_matches_jax_vjp(shape, dtype, with_res):
    rng = np.random.default_rng(4)
    x, r, dy = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    w = (1 + 0.3 * rng.standard_normal(shape[-1:])).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [jnp.asarray(a, jdt) for a in (x, w) + ((r,) if with_res else ())]

    def f(x_, w_, *res):
        return jax_rmsnorm_ref(x_, w_, res[0] if res else None, eps=1e-5)
    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(dy, jdt))
    xt, wt, rt, dyt = (torch.from_numpy(a).to(dtype) for a in (x, w, r, dy))
    got = rmsnorm_bwd(xt, wt, dyt, rt if with_res else None, eps=1e-5)
    assert (got[2] is None) == (not with_res)
    for name, g, wnt in zip(("dx", "dw", "dresidual"), got, want):
        _close_grad(g, wnt, dtype, name)


@pytest.mark.parametrize("shape,ctas", [((4, 64), None), ((2, 8, 128), 3),
                                        ((3, 96), 1), ((37, 160), None),
                                        ((37, 160), 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_dw_two_passes_match(shape, ctas, dtype, with_res):
    """The backward kernel's dw in two passes (CTA c's partial over rows c,
    c + C, ..., then the column sum), mirrored in plain PyTorch, against
    ``rmsnorm_bwd``'s dw and ``jax.vjp`` of the reference's oracle."""
    rng = np.random.default_rng(6)
    x, r, dy = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    w = (1 + 0.3 * rng.standard_normal(shape[-1:])).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [jnp.asarray(a, jdt) for a in (x, w) + ((r,) if with_res else ())]

    def f(x_, w_, *res):
        return jax_rmsnorm_ref(x_, w_, res[0] if res else None, eps=1e-5)
    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(dy, jdt))[1]
    xt, wt, rt, dyt = (torch.from_numpy(a).to(dtype) for a in (x, w, r, dy))
    res = rt if with_res else None
    rows = int(np.prod(shape[:-1]))
    part, dw = rmsnorm_dw_partials(xt, wt, dyt, res, 1e-5, ctas)
    n = bwd_ctas(rows) if ctas is None else ctas
    assert part.shape == (n, shape[-1]) and part.dtype == torch.float32
    assert dw.dtype == wt.dtype
    closed = rmsnorm_bwd(xt, wt, dyt, res, eps=1e-5)[1]
    torch.testing.assert_close(dw.float(), closed.float(),
                               **(dict(rtol=1e-5, atol=1e-5)
                                  if dtype == torch.float32 else
                                  dict(rtol=1e-2, atol=1e-2)))
    _close_grad(dw, want, dtype, "dw")


def test_rmsnorm_bwd_mixed_weight_dtype():
    """fp32 activations normed with bf16 weights: each gradient comes back
    in its input's type."""
    rng = np.random.default_rng(5)
    x, dy = (rng.standard_normal((5, 96)).astype(np.float32)
             for _ in range(2))
    w = rng.standard_normal((96,)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm_ref(a, b),
                     jnp.asarray(x), jnp.asarray(w, jnp.bfloat16))
    want = vjp(jnp.asarray(dy))
    got = rmsnorm_bwd(torch.from_numpy(x),
                      torch.from_numpy(w).to(torch.bfloat16),
                      torch.from_numpy(dy))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    _close_grad(got[0], want[0], torch.float32, "dx")
    _close_grad(got[1], want[1], torch.bfloat16, "dw")


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------
def _setup(microbatches=1, compression=False):
    arch = reduced(get_arch("phi4-mini-3.8b"), n_layers=2, d_model=32,
                   vocab=64, d_ff=64)
    model = LM(arch, device="cpu", loss_chunk=8)
    cfg = tt.TrainConfig(adamw=tt.AdamWConfig(lr=1e-2, warmup_steps=2,
                                              total_steps=50),
                         microbatches=microbatches,
                         grad_compression=compression)
    params, opt = tt.init_train_state(model, torch.Generator().manual_seed(0),
                                      cfg)
    dcfg = tt.DataConfig(vocab=arch.vocab, seq_len=16, global_batch=4)
    return arch, model, cfg, params, opt, dcfg


def test_loss_decreases():
    arch, model, cfg, params, opt, dcfg = _setup()
    step = tt.make_train_step(model, cfg)
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt, tt.batch_at_step(dcfg, i % 2))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses[::10]
    assert np.isfinite(losses).all()


def test_microbatch_equivalence():
    arch, model, cfg, params, opt, dcfg = _setup()
    batch = tt.batch_at_step(dcfg, 0)
    l1, g1, _ = tt.loss_and_grads(model, params, batch, microbatches=1)
    l2, g2, _ = tt.loss_and_grads(model, params, batch, microbatches=2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=2e-2)
    for a, b in zip(topt.tree_leaves(g1), topt.tree_leaves(g2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0.1, atol=0.02)


def test_checkpoint_roundtrip_and_restart(tmp_path):
    arch, model, cfg, params, opt, dcfg = _setup()
    step = tt.make_train_step(model, cfg)
    for i in range(3):
        params, opt, _ = step(params, opt, tt.batch_at_step(dcfg, i))
    tt.save(str(tmp_path), 3, {"params": params, "opt": opt},
            extra={"data_step": 3})
    # continue 2 more steps
    p2, o2 = params, opt
    for i in range(3, 5):
        p2, o2, m_direct = step(p2, o2, tt.batch_at_step(dcfg, i))
    # restart from checkpoint and replay
    assert tt.latest_step(str(tmp_path)) == 3
    restored, extra = tt.load(str(tmp_path), 3,
                              {"params": params, "opt": opt})
    assert extra["data_step"] == 3
    p3, o3 = restored["params"], restored["opt"]
    for i in range(3, 5):
        p3, o3, m_restart = step(p3, o3, tt.batch_at_step(dcfg, i))
    np.testing.assert_allclose(float(m_direct["loss"]),
                               float(m_restart["loss"]), rtol=1e-5)
    for a, b in zip(topt.tree_leaves(p2), topt.tree_leaves(p3)):
        assert torch.equal(a, b)


def test_int8_compression_roundtrip_and_ef():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    q, s = topt.compress_int8(g)
    deq = topt.decompress_int8(q, s)
    assert float((deq - g).abs().max()) <= float(s) * 0.51
    # error feedback: accumulated compressed grads converge to the truth
    grads = {"w": g}
    ef = {"w": torch.zeros_like(g)}
    acc = torch.zeros_like(g)
    for _ in range(16):
        cg, ef = topt.compressed_grads_with_ef(grads, ef)
        acc = acc + cg["w"]
    np.testing.assert_allclose((acc / 16).numpy(), g.numpy(),
                               atol=float(s) * 0.2)


def test_compressed_training_still_converges():
    arch, model, cfg, params, opt, dcfg = _setup(compression=True)
    step = tt.make_train_step(model, cfg)
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt, tt.batch_at_step(dcfg, i % 2))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9


def test_elastic_resharding_load(tmp_path):
    """A checkpoint loads into whatever device and type ``like`` holds
    (bf16 params into fp32 leaves) and, with ``shardings=``, re-shards
    onto a mesh (it raised before that was ported): here on rank 0 of a
    fake process group of two ranks, each leaf by its spec (the embedding
    by a (mesh, placements) pair), rank 0 keeps its shard of the saved
    leaf, bit for bit. ``tests/test_torch_dist.py`` round-trips it on
    real ranks."""
    arch, model, cfg, params, opt, dcfg = _setup()
    tt.save(str(tmp_path), 1, {"params": params})
    like = {"params": topt.tree_map(lambda t: t.float(), params)}
    restored, _ = tt.load(str(tmp_path), 1, like)
    for a, b in zip(topt.tree_leaves(params),
                    topt.tree_leaves(restored["params"])):
        assert b.dtype == torch.float32 and b.device == a.device
        assert torch.equal(a.float(), b)
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import (PSpec, make_policy,
                                                  placements)
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch_dist_jobs import fake_world
    with fake_world(2) as mesh:
        pol = make_policy(arch, ShapeSpec("t", "decode", 16, 2), mesh)
        specs = LM(arch, pol, device="cpu").param_specs()
        specs["embed"] = (mesh, placements(specs["embed"], mesh))
        got, _ = tt.load(str(tmp_path), 1, like,
                         shardings={"params": specs}, mesh=mesh)
        sharded = 0
        for a, b, sp in zip(topt.tree_leaves(like["params"]),
                            topt.tree_leaves(got["params"]),
                            topt.tree_leaves(specs)):
            pl = placements(sp, mesh) if isinstance(sp, PSpec) else sp[1]
            want = distribute_tensor(a, mesh, pl, src_data_rank=None)
            assert isinstance(b, DTensor)
            assert tuple(b.placements) == tuple(want.placements)
            assert torch.equal(b.to_local(), want.to_local())
            sharded += b.to_local().shape != a.shape
        assert sharded


# ---------------------------------------------------------------------------
# twin of tests/test_models_smoke.py::test_train_step_smoke
# ---------------------------------------------------------------------------
def _batch_for(arch, b=2, s=16):
    rng = np.random.default_rng(0)
    batch = {"labels": torch.as_tensor(rng.integers(0, arch.vocab, (b, s)))}
    if arch.family.value == "audio":
        batch["embeds"] = torch.as_tensor(
            rng.standard_normal((b, s, arch.d_model)), dtype=torch.float32)
    else:
        batch["tokens"] = torch.as_tensor(rng.integers(0, arch.vocab, (b, s)))
    if arch.family.value == "vlm":
        batch["frontend"] = torch.as_tensor(
            rng.standard_normal((b, arch.n_frontend_tokens, arch.d_model)),
            dtype=torch.float32)
    return batch


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_train_step_smoke(name):
    """Finite positive loss, and a finite gradient reaching every leaf the
    loss reads (an audio model takes embeddings, so its embedding table
    is the one leaf no gradient reaches): a cut in the autograd graph
    leaves a leaf's .grad at None."""
    arch = reduced(get_arch(name))
    model = LM(arch, device="cpu", loss_chunk=8)
    params = model.init(torch.Generator().manual_seed(0))
    for t in topt.tree_leaves(params):
        t.requires_grad_()
    loss, metrics = model.train_loss(params, _batch_for(arch))
    assert np.isfinite(float(loss.detach())), (name, loss)
    assert float(loss.detach()) > 0
    loss.backward()
    unread = {"embed"} if arch.family.value == "audio" else set()
    for key, t in _leaves(params):
        if key in unread:
            assert t.grad is None, key
            continue
        assert t.grad is not None, (name, key)
        assert bool(torch.isfinite(t.grad.float()).all()), (name, key)


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
def test_train_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--smoke", "--steps", "3", "--microbatches", "2",
                      "--compression", "--device", "cpu"])
    assert out["device"] == "cpu" and out["start"] == 0
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "[train] done on cpu" in capsys.readouterr().out


def test_train_launcher_refuses_full_size():
    """Without ``--smoke`` the launcher trains at full size on the
    production mesh (it raised before that was ported); on this world of
    no ranks the mesh refuses, with the reference's RuntimeError."""
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="need 256 devices"):
        train.main(["--device", "cpu"])
    with pytest.raises(RuntimeError, match="need 512 devices"):
        train.main(["--device", "cpu", "--multi-pod"])


def test_train_example_resumes_to_the_same_params(tmp_path):
    """Direct: 4 steps, checkpoints at 2 and 4. Restarted: the same run
    with its step-4 checkpoint removed resumes at 2 and runs 2 more. Both
    step-4 checkpoints hold the same params and state, bit for bit."""
    from repro_torch.examples import train_example
    direct, resumed = str(tmp_path / "direct"), str(tmp_path / "resumed")
    a = train_example.main(device="cpu", steps=4, ckpt=direct, ckpt_every=2)
    assert a["start"] == 0 and len(a["losses"]) == 4
    train_example.main(device="cpu", steps=4, ckpt=resumed, ckpt_every=2)
    import shutil
    shutil.rmtree(tmp_path / "resumed" / "step_00000004")
    b = train_example.main(device="cpu", steps=4, ckpt=resumed, ckpt_every=2)
    assert b["start"] == 2 and b["losses"] == a["losses"][2:]
    root = tmp_path / "direct" / "step_00000004"
    other = tmp_path / "resumed" / "step_00000004"
    manifest = json.loads((root / "manifest.json").read_text())
    assert manifest == json.loads((other / "manifest.json").read_text())
    for leaf in manifest["leaves"]:
        np.testing.assert_array_equal(
            np.load(root / "arrays" / leaf["file"]),
            np.load(other / "arrays" / leaf["file"]), leaf["key"])
