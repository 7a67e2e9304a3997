"""The port's MoE (``repro_torch.models.moe`` and the MoE family of ``LM``)
against the reference's on the same seeded inputs and converted weights:
the routed FFN (outputs, load-balance loss and drops) at prefill and decode
shapes, capacity overflow, padded experts and a local expert slice, router
ties resolved as ``jax.lax.top_k`` resolves them, and ``LM.prefill`` /
``decode_step`` / ``maybe_flush`` for reduced qwen2-moe-a2.7b and
moonshot-v1-16b-a3b in fp32 and bf16.

bf16 generation is held against the reference run layer by layer
(``ExecConfig(scan_layers=False)``): under ``lax.scan`` XLA compiles the
layer body as one computation and may keep fused bf16 chains in fp32
(``xla_allow_excess_precision``), so its roundings, and with them a
router's top-k, differ from op-by-op dispatch; with that flag off the
scanned reference equals the port bit for bit (ROADMAP C9)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import LM as JaxLM  # noqa: E402
from repro.models.model import ExecConfig  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from test_torch_generation import _check_cache  # noqa: E402
from test_torch_models import _close_model  # noqa: E402

MOE_ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]
KW = dict(d_model=64, vocab=128)


def _archs(name, param_dtype, n_layers=2):
    kw = dict(KW, n_layers=n_layers)
    return (dataclasses.replace(jax_reduced(jax_get_arch(name), **kw),
                                param_dtype=param_dtype),
            dataclasses.replace(reduced(get_arch(name), **kw),
                                param_dtype=param_dtype))


def _moe_layer(name, param_dtype):
    """Layer 0 of the MoE segment (the last segment) of the reduced arch:
    the reference's leaves and their conversion."""
    ja, ta = _archs(name, param_dtype)
    jm = JaxLM(ja)
    jp = jm.init(jax.random.key(0))
    seg = jp[f"seg{len(jm.segments) - 1}"]
    jl = jax.tree.map(lambda t: t[0], seg)
    return ja, ta, jl, params_from_jax_numpy(jax.tree.map(np.asarray, jl))


def _x(shape, param_dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.float32 if param_dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.asarray(xj, np.float32))
    return xj, xt.to(torch.float32 if param_dtype == "float32"
                     else torch.bfloat16)


def _check_aux(got, want, param_dtype="float32"):
    """The load-balance loss (fp32, from the router's probabilities) to
    the dtype's tolerance, the drop count exactly."""
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got[0].item(), want[0],
                               rtol=1e-5 if param_dtype == "float32"
                               else 2e-2)
    assert got[1].item() == want[1], (got.tolist(), want.tolist())


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(2, 40), (16, 1)], ids=["prefill",
                                                          "decode"])
def test_moe_ffn_matches_jax(name, param_dtype, b, s):
    """Output and aux of ``moe_ffn`` on one layer's converted weights. The
    decode shape (16 x 1 tokens) has a capacity of 5 for 32 assignments
    over 8 experts, so some are dropped, and exactly the same ones."""
    ja, ta, jl, tl = _moe_layer(name, param_dtype)
    xj, xt = _x((b, s, ja.d_model), param_dtype)
    want, waux = jax_moe.moe_ffn(xj, jl, ja)
    got, gaux = moe.moe_ffn(xt, tl, ta)
    assert got.shape == (b, s, ja.d_model) and got.dtype == xt.dtype
    _close_model(got, want, param_dtype)
    _check_aux(gaux, waux, param_dtype)
    if s == 1:
        assert gaux[1].item() > 0, "the decode case should drop"


def _local_args(tl, jl, case, t):
    """(port kwargs, JAX kwargs, port weights, JAX weights) of one
    ``_moe_local`` case on an 8-expert layer."""
    top_k, n_real = 2, 8
    kw = dict(top_k=top_k, n_real=n_real, n_pad=n_real, e_lo=0,
              capacity=max(int(t * top_k / n_real * 1.25), 4), act="silu")
    names = ("w_gate", "w_up", "w_down")
    tw = [tl[k] for k in names]
    jw = [jl[k] for k in names]
    if case == "overflow":                 # 2 of ~5 per expert kept
        kw["capacity"] = 2
    elif case == "padded":                 # 4 dummy experts, -inf logits
        kw["n_pad"] = 12
        tw = [torch.cat([w, w[:4]]) for w in tw]
        jw = [jnp.concatenate([w, w[:4]]) for w in jw]
    elif case == "local_slice":            # experts [2, 6) of 8
        kw["e_lo"] = 2
        tw = [w[2:6] for w in tw]
        jw = [w[2:6] for w in jw]
    return kw, tw, jw


@pytest.mark.parametrize("case", ["fits", "overflow", "padded",
                                  "local_slice"])
def test_moe_local_matches_jax(case):
    """The routed core with capacity to spare, with capacity overflow, with
    padded dummy experts, and over a local slice of the experts (the
    expert-parallel rank's view), in fp32."""
    _, _, jl, tl = _moe_layer("qwen2-moe-a2.7b", "float32")
    t = 20
    xj, xt = _x((t, 64), "float32", seed=2)
    kw, tw, jw = _local_args(tl, jl, case, t)
    want, waux = jax_moe._moe_local(xj, jl["router"], *jw, **kw)
    got, gaux = moe._moe_local(xt, tl["router"], *tw, **kw)
    _close_model(got, want, "float32")
    _check_aux(gaux, waux)
    if case == "overflow":
        assert gaux[1].item() > 0


def test_top_k_breaks_ties_as_jax():
    """Equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.4, 0.2, 0.4, 0.0],
                      [0.2, 0.2, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_moe_ffn_router_tie_matches_jax(param_dtype):
    """A router that ties every expert (zero weights): each token goes to
    experts 0 and 1, whose capacity overflows, as in the reference."""
    ja, ta, jl, tl = _moe_layer("qwen2-moe-a2.7b", param_dtype)
    jl = dict(jl, router=jnp.zeros_like(jl["router"]))
    tl = dict(tl, router=torch.zeros_like(tl["router"]))
    xj, xt = _x((2, 16, ja.d_model), param_dtype, seed=3)
    want, waux = jax_moe.moe_ffn(xj, jl, ja)
    got, gaux = moe.moe_ffn(xt, tl, ta)
    _close_model(got, want, param_dtype)
    _check_aux(gaux, waux, param_dtype)
    capacity = int(32 * 2 / 8 * 1.25)
    assert gaux[1].item() == 2 * (32 - capacity)


def test_moe_ffn_refuses_expert_parallelism():
    """Expert parallelism no longer refuses (it raised before it was
    ported): a policy whose "experts" axis spans two ranks runs it (held
    against the reference's sharded ``moe_ffn`` on real ranks in
    ``tests/test_torch_dist.py``). On a fake process group of two ranks,
    whose all-reduce leaves each rank's part as it is, rank 0's output
    and aux are its own experts' share: ``_moe_local`` on experts [0, 4)
    with the capacity of its tokens, the load-balance loss weighted 1/2.
    What ``moe_ffn`` still refuses is an expert stack that is not the
    padded count (ValueError)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import make_policy
    from torch_dist_jobs import fake_world
    ja, ta, jl, tl = _moe_layer("qwen2-moe-a2.7b", "float32")
    x = _x((2, 8, ta.d_model), "float32")[1]
    with fake_world(2) as mesh:
        pol = make_policy(ta, ShapeSpec("t", "prefill", 8, 2), mesh)
        assert pol.axis_size("experts") == 2
        axes = {"router": (None, None), "w_gate": ("experts", None, None),
                "w_up": ("experts", None, None),
                "w_down": ("experts", None, None)}
        p = {k: pol.distribute(tl[k], ax) for k, ax in axes.items()}
        out, aux = moe.moe_ffn(pol.distribute(x, ("batch", None, None)), p,
                               ta, pol)
        want, waux = moe._moe_local(
            x.reshape(16, -1), tl["router"].float(), tl["w_gate"][:4],
            tl["w_up"][:4], tl["w_down"][:4], top_k=ta.moe.top_k,
            n_real=8, n_pad=8, e_lo=0, capacity=max(int(16 * 2 / 8 * 1.25),
                                                    4), act=ta.act)
        assert tuple(p["w_gate"].to_local().shape)[0] == 4
        torch.testing.assert_close(out.to_local(), want.reshape(x.shape),
                                   rtol=0, atol=0)
        torch.testing.assert_close(aux.to_local(),
                                   waux * torch.tensor([0.5, 1.0]),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        moe.moe_ffn(torch.zeros((1, 4, ta.d_model)),
                    dict(tl, w_gate=tl["w_gate"][:4]), ta)


def _lms(name, param_dtype, window, capacity_factor=None):
    ja, ta = _archs(name, param_dtype, n_layers=3)
    jm = JaxLM(ja, exec_cfg=ExecConfig(
        recent_window=window, capacity_factor=capacity_factor,
        scan_layers=param_dtype == "float32"))
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, LM(ta, device="cpu", recent_window=window,
                      capacity_factor=capacity_factor), tp


def _ref_aux(jm, jp, toks):
    """The reference prefill's summed MoE aux (``prefill`` drops it)."""
    return jm._forward_full(jp, jm._embed_inputs(jp, jnp.asarray(toks)))[2]


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_moe_generation_matches_jax(name, param_dtype):
    """Prefill logits, aux and every cache leaf, then 3 decode steps with a
    flush after the 2nd (recent window 2), and the caches at the end, on
    converted weights (3 layers: moonshot's dense first layer and two MoE
    layers, qwen's three MoE layers)."""
    jm, jp, tm, tp = _lms(name, param_dtype, window=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(2, jm.arch.vocab, (2, 40))
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks), s_max=48)
    tl, tc, taux = tm.prefill(tp, torch.from_numpy(toks), s_max=48,
                              return_aux=True)
    assert tl.dtype == torch.float32 and tl.shape == (2, jm.arch.vocab)
    _close_model(tl, jl, param_dtype)
    _check_cache(tc, jc, param_dtype)
    _check_aux(taux, _ref_aux(jm, jp, toks), param_dtype)
    for i, tok in enumerate(rng.integers(2, jm.arch.vocab, (3, 2))):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_model(tl, jl, param_dtype)
        if i == 1:
            jc, tc = jm.maybe_flush(jc), tm.maybe_flush(tc)
    _check_cache(tc, jc, param_dtype)


def test_capacity_factor_matches_jax():
    """``LM(capacity_factor=...)`` sizes capacity as the reference's
    ``ExecConfig.capacity_factor`` does: a smaller factor drops more, and
    the same assignments."""
    drops = []
    for cf in (None, 0.5):
        jm, jp, tm, tp = _lms("qwen2-moe-a2.7b", "float32", window=4,
                              capacity_factor=cf)
        toks = np.random.default_rng(6).integers(2, jm.arch.vocab, (2, 24))
        jl, _ = jm.prefill(jp, tokens=jnp.asarray(toks))
        tl, _, taux = tm.prefill(tp, torch.from_numpy(toks), return_aux=True)
        _close_model(tl, jl, "float32")
        _check_aux(taux, _ref_aux(jm, jp, toks))
        drops.append(taux[1].item())
    assert drops[1] > drops[0]


def test_decode_step_aux_counts_decode_drops():
    """``decode_step(return_aux=True)`` sums the MoE layers' aux; at a
    batch of 12 the floor capacity of 4 drops assignments."""
    _, ta = _archs("qwen2-moe-a2.7b", "float32")
    model = LM(ta, device="cpu", recent_window=4)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        2, ta.vocab, (12, 8)))
    _, cache = model.prefill(params, toks, s_max=16)
    logits, _, aux = model.decode_step(params, cache, toks[:, -1],
                                       return_aux=True)
    assert logits.shape == (12, ta.vocab) and aux.shape == (2,)
    assert aux[1].item() > 0 and aux[1].item() == int(aux[1].item())


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_params_match_jax_layout_and_convert(name):
    """The template's leaf names and shapes are the reference's (stacked
    expert leaves (L, E, D, F)), and a bf16 tree converts key for key and
    value for value."""
    ja, ta = _archs(name, "bfloat16", n_layers=3)
    jm = JaxLM(ja)

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in t.items()}
    assert shapes(LM(ta, device="cpu").param_template()) == \
        shapes(jm.param_template())
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tp = params_from_jax_numpy(jp)
    assert sorted(tp) == sorted(jp)
    for s in (k for k in jp if k.startswith("seg")):
        assert sorted(tp[s]) == sorted(jp[s])
        for k, v in jp[s].items():
            assert tp[s][k].dtype == torch.bfloat16, (s, k)
            assert tuple(tp[s][k].shape) == v.shape, (s, k)
            np.testing.assert_array_equal(tp[s][k].float().numpy(),
                                          np.asarray(v, np.float32))
    last = tp[f"seg{len(jm.segments) - 1}"]
    m = ta.moe
    assert last["w_gate"].shape == (jm.segments[-1].n, m.n_experts,
                                    ta.d_model, m.d_expert)
