"""A configuration that brings its own layout module, by files alone, and
the dense default that a configuration without one keeps.

The dense default is held against a copy of the functions it replaced
(weights tensor for tensor, the port's ArchConfig, the counts of work and
the rooflines' bounds). Two of the port's non-dense families enter as a
configuration file and a layout module written into the test's directory
(``tiny.layout_config``), nothing of ``pbcore`` edited: their weights pass
the port's own layout check and drive ``LM.prefill`` on the CPU."""
import dataclasses
import math
import types
from typing import Dict

import pytest

torch = pytest.importorskip("torch")

from pbcore import harness, readings, serve, spec, tiny, work  # noqa: E402
from pbcore.serve import Step  # noqa: E402


# -- the dense default, against the functions it replaced, copied whole ----

PARENT_ARCH_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                    "num_attention_heads": "n_heads",
                    "num_key_value_heads": "n_kv_heads",
                    "intermediate_size": "d_ff", "vocab_size": "vocab",
                    "head_dim": "head_dim",
                    "tie_word_embeddings": "tie_embeddings",
                    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
                    "hidden_act": "act", "attention_bias": "qkv_bias"}
PARENT_DTYPES = {"bfloat16": "bfloat16", "float32": "float32"}


def parent_port_arch(cfg: Dict):
    from repro_torch.configs import get_arch
    kw = {field: cfg[key] for key, field in PARENT_ARCH_KEYS.items()
          if key in cfg}
    kw["param_dtype"] = PARENT_DTYPES[cfg["torch_dtype"]]
    arch = dataclasses.replace(get_arch(cfg["port_arch"]), **kw)
    hd = arch.resolved_head_dim
    runs = {"embedding_multiplier":
            (math.sqrt(arch.d_model) if arch.tie_embeddings else 1.0, 1.0),
            "attention_multiplier": (1.0 / math.sqrt(hd),) * 2,
            "residual_multiplier": (1.0, 1.0), "logits_scaling": (1.0, 1.0),
            "partial_rotary_factor": (1.0, 1.0)}
    for key, (value, default) in runs.items():
        if not math.isclose(cfg.get(key, default), value, rel_tol=1e-9):
            raise ValueError(f"{cfg['port_arch']}: {key} "
                             f"{cfg.get(key, default)} is not what the port "
                             f"runs ({value})")
    if cfg.get("rope_scaling") is not None:
        raise ValueError("the port's RoPE takes no scaling")
    return arch


def parent_leaf_shapes(cfg: Dict) -> Dict:
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    ff, V = cfg["intermediate_size"], cfg["vocab_size"]
    qd, kvd = hq * hd, hkv * hd
    seg = {"ln1": ((L, d), "norm"), "ln2": ((L, d), "norm"),
           "wq": ((L, d, qd), d), "wk": ((L, d, kvd), d),
           "wv": ((L, d, kvd), d), "wo": ((L, qd, d), qd),
           "wg": ((L, d, ff), d), "wu": ((L, d, ff), d),
           "wd": ((L, ff, d), ff)}
    return {"embed": ((V, d), "embed"), "final_ln": ((d,), "norm"),
            "seg0": seg}


def parent_make_weights(cfg: Dict, seed: int, device) -> Dict:
    dtype = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d = cfg["hidden_size"]

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    def make(shape, kind):
        if kind == "norm":
            return randn(shape).mul_(0.1).add_(1.0)
        if kind != "embed":
            return randn(shape).mul_(1.0 / math.sqrt(kind))
        return randn(shape).mul_(1.0 / d)

    def walk(node):
        return {k: walk(node[k]) if isinstance(node[k], dict)
                else make(*node[k]) for k in sorted(node)}
    return walk(parent_leaf_shapes(cfg))


def parent_token_flops(cfg):
    s = work.sizes(cfg)
    return 2.0 * (s["L"] * work.layer_params(cfg) + s["d"])


def parent_head_flops(cfg):
    s = work.sizes(cfg)
    return 2.0 * s["d"] * s["V"]


def parent_attn_flops(cfg, keys):
    s = work.sizes(cfg)
    return 4.0 * s["hq"] * s["hd"] * keys * s["L"]


def parent_paged_decode_work(cfg, batch, total_keys, max_pages, esz=4):
    s = work.sizes(cfg)
    nbytes = ((2 * total_keys * s["hkv"] * s["hd"]
               + 2 * batch * s["hq"] * s["hd"]) * esz
              + batch * max_pages * 4 + batch * 4)
    return 4.0 * total_keys * s["hq"] * s["hd"], float(nbytes)


def parent_flash_f32_work(cfg, rows, done, esz=4):
    s = work.sizes(cfg)
    pairs = rows * done + rows * (rows + 1) / 2
    nbytes = (2 * rows * s["hq"] * s["hd"]
              + 2 * (done + rows) * s["hkv"] * s["hd"]) * esz + 4
    return 4.0 * s["hq"] * s["hd"] * pairs, float(nbytes)


def parent_paged_decode_bounds(o):
    cfg, L = o.cfg, o.cfg["num_hidden_layers"]
    max_pages = int(o.cell.workload["engine"]["max_pages_per_seq"])
    bounds = []
    for s in o.span_steps():
        if s.kind == "decode":
            fl, by = parent_paged_decode_work(cfg, s.tokens, s.context,
                                              max_pages)
            bounds += [work.bound_s(fl, by)] * L
    return bounds


def parent_flash_f32_bounds(o):
    cfg, L = o.cfg, o.cfg["num_hidden_layers"]
    chunk = int(o.cell.workload["engine"].get("prefill_chunk", 0))
    bounds = []
    for s in o.span_steps():
        if s.kind != "prefill":
            continue
        for n in s.l_ins:
            for rows, done in work.chunk_plan(n, chunk):
                fl, by = parent_flash_f32_work(cfg, rows, done)
                bounds += [work.bound_s(fl, by)] * L
    return bounds


DENSE_SIZES = [dict(), dict(layers=3, d=96, hq=6, hkv=2, hd=16, ff=160,
                            vocab=300, dtype="float32")]


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.mark.parametrize("wrap", [dict, spec.Config], ids=["dict", "Config"])
@pytest.mark.parametrize("size", range(len(DENSE_SIZES)))
def test_the_dense_default_is_unchanged(size, wrap):
    cfg = wrap(tiny.config(**DENSE_SIZES[size]))
    assert spec.layout(cfg) is None
    arch = serve.port_arch(cfg)
    assert arch == parent_port_arch(cfg)
    assert serve.leaf_shapes(cfg) == parent_leaf_shapes(cfg)
    weights = serve.make_weights(cfg, 2**31 + 11, "cpu")
    got = dict(_leaves(weights))
    want = dict(_leaves(parent_make_weights(cfg, 2**31 + 11, "cpu")))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    serve.check_layout(arch, weights)

    assert work.attn_layers(cfg) == cfg["num_hidden_layers"]
    assert work.token_flops(cfg) == parent_token_flops(cfg)
    assert work.head_flops(cfg) == parent_head_flops(cfg)
    for keys in (1, 37, 4096.5):
        assert work.attn_flops(cfg, keys) == parent_attn_flops(cfg, keys)
    for n in (1, 30, 97):
        assert work.prefill_flops(cfg, n) == (
            parent_token_flops(cfg) * n
            + parent_attn_flops(cfg, n * (n + 1) / 2)
            + parent_head_flops(cfg))
    assert work.decode_flops(cfg, 5, 611) == (
        (parent_token_flops(cfg) + parent_head_flops(cfg)) * 5
        + parent_attn_flops(cfg, 611))

    steps = [Step(0, 0, 1, "decode", tokens=3, context=200),
             Step(1, 1, 2, "prefill", tokens=130, l_ins=(20, 110)),
             Step(0, 2, 3, "decode", tokens=7, context=1100),
             Step(1, 3, 4, "idle"),
             Step(0, 4, 5, "prefill", tokens=70, l_ins=(70,))]
    o = types.SimpleNamespace(
        cfg=cfg, span_steps=lambda: steps,
        cell=types.SimpleNamespace(workload={"engine": {
            "max_pages_per_seq": 16, "prefill_chunk": 24}}))
    assert readings.paged_decode_bounds(o) == parent_paged_decode_bounds(o)
    assert readings.flash_f32_bounds(o) == parent_flash_f32_bounds(o)
    assert len(readings.paged_decode_bounds(o)) == \
        2 * cfg["num_hidden_layers"]


# -- two of the port's non-dense families, by files alone ------------------

MOE_LAYOUT = '''"""A throwaway layout of the port's MoE family (qwen2-moe-a2.7b's):
every layer attends (q, k and v with biases) and ends in routed experts and
one shared expert; the file's keys as Qwen1.5-MoE's config.json names
them."""
import dataclasses


def port_arch(cfg):
    from repro_torch.configs import get_arch
    if not cfg["norm_topk_prob"]:
        raise ValueError("the port renormalises the top-k weights")
    if cfg["decoder_sparse_step"] != 1 or cfg["mlp_only_layers"]:
        raise ValueError("the port's experts are in every layer")
    base = get_arch(cfg["port_arch"])
    moe = dataclasses.replace(
        base.moe, n_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"],
        d_expert=cfg["moe_intermediate_size"],
        d_shared=cfg["shared_expert_intermediate_size"], n_dense_layers=0)
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], vocab=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], act=cfg["hidden_act"],
        moe=moe, param_dtype=cfg["torch_dtype"])


def _sizes(cfg):
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = d // hq
    return (d, hq * hd, cfg["num_key_value_heads"] * hd, cfg["num_experts"],
            cfg["moe_intermediate_size"],
            cfg["shared_expert_intermediate_size"])


def leaf_shapes(cfg):
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    d, qd, kvd, e, f, fs = _sizes(cfg)
    bias = ("normal", 0.02)
    seg = {"ln1": ((L, d), "norm"), "ln2": ((L, d), "norm"),
           "wq": ((L, d, qd), d), "wk": ((L, d, kvd), d),
           "wv": ((L, d, kvd), d), "wo": ((L, qd, d), qd),
           "bq": ((L, qd), bias), "bk": ((L, kvd), bias),
           "bv": ((L, kvd), bias), "router": ((L, d, e), d),
           "w_gate": ((L, e, d, f), d), "w_up": ((L, e, d, f), d),
           "w_down": ((L, e, f, d), f), "sh_gate": ((L, d, fs), d),
           "sh_up": ((L, d, fs), d), "sh_down": ((L, fs, d), fs)}
    out = {"embed": ((V, d), "embed"), "final_ln": ((d,), "norm"),
           "seg0": seg}
    if not cfg["tie_word_embeddings"]:
        out["head"] = ((d, V), d)
    return out


def attn_layers(cfg):
    return cfg["num_hidden_layers"]


def token_flops(cfg):
    """2 x the parameters a token meets: attention's projections and
    biases, the router, its top-k experts, the shared expert, two norms a
    layer, and the final norm."""
    d, qd, kvd, e, f, fs = _sizes(cfg)
    k = cfg["num_experts_per_tok"]
    layer = (2 * d * qd + 2 * d * kvd + qd + 2 * kvd + d * e
             + 3 * d * f * k + 3 * d * fs + 2 * d)
    return 2.0 * (cfg["num_hidden_layers"] * layer + d)
'''

SSM_LAYOUT = '''"""A throwaway layout of the port's SSM family (mamba2-1.3b's): every
layer a Mamba-2 mixer, no attention and no MLP; the file's keys as
Mamba2's config.json names them."""
import dataclasses


def port_arch(cfg):
    from repro_torch.configs import get_arch
    if cfg["use_bias"] or not cfg["use_conv_bias"]:
        raise ValueError("the port's projections take no bias, its "
                         "convolutions take one")
    base = get_arch(cfg["port_arch"])
    ssm = dataclasses.replace(
        base.ssm, d_state=cfg["state_size"], d_conv=cfg["conv_kernel"],
        expand=cfg["expand"], head_dim=cfg["head_dim"],
        chunk=cfg["chunk_size"], ngroups=cfg["n_groups"])
    arch = dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        vocab=cfg["vocab_size"], norm_eps=cfg["layer_norm_epsilon"],
        tie_embeddings=cfg["tie_word_embeddings"], ssm=ssm,
        param_dtype=cfg["torch_dtype"])
    if arch.n_ssm_heads != cfg["num_heads"]:
        raise ValueError(f"{cfg['num_heads']} heads; the port runs "
                         f"{arch.n_ssm_heads}")
    return arch


def _sizes(cfg):
    d = cfg["hidden_size"]
    return (d, cfg["expand"] * d, cfg["num_heads"],
            cfg["n_groups"] * cfg["state_size"], cfg["conv_kernel"])


def leaf_shapes(cfg):
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    d, di, nh, gn, k = _sizes(cfg)
    bias = ("normal", 0.1)
    seg = {"ln": ((L, d), "norm"), "w_z": ((L, d, di), d),
           "w_x": ((L, d, di), d), "w_bc": ((L, d, 2 * gn), d),
           "w_dt": ((L, d, nh), d), "dt_bias": ((L, nh), bias),
           "conv_wx": ((L, k, di), k), "conv_bx": ((L, di), bias),
           "conv_wbc": ((L, k, 2 * gn), k), "conv_bbc": ((L, 2 * gn), bias),
           "A_log": ((L, nh), ("log_uniform", 1.0, 16.0), "float32"),
           "D": ((L, nh), "norm"), "norm_w": ((L, di), "norm"),
           "w_out": ((L, di, d), di)}
    out = {"embed": ((V, d), "embed"), "final_ln": ((d,), "norm"),
           "seg0": seg}
    if not cfg["tie_word_embeddings"]:
        out["head"] = ((d, V), d)
    return out


def attn_layers(cfg):
    return 0


def token_flops(cfg):
    """2 x the parameters a token meets (projections, convolutions, gains
    and biases), and the SSD's state update and read-out, 2 x heads x P x
    N each, every layer; and the final norm."""
    d, di, nh, gn, k = _sizes(cfg)
    params = (d * (2 * di + 2 * gn + nh) + k * (di + 2 * gn) + di * d
              + 2 * nh + di + 2 * gn + 2 * nh + di + d)
    scan = 4 * di * cfg["state_size"]
    return cfg["num_hidden_layers"] * (2.0 * params + scan) + 2.0 * d
'''

FAMILIES = {
    "moe": (MOE_LAYOUT, {
        "port_arch": "qwen2-moe-a2.7b", "layout": "t_qwen2_moe",
        "model_type": "qwen2_moe", "num_hidden_layers": 2,
        "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "vocab_size": 256,
        "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
        "num_experts": 8, "num_experts_per_tok": 2, "norm_topk_prob": True,
        "decoder_sparse_step": 1, "mlp_only_layers": [],
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False, "hidden_act": "silu",
        "torch_dtype": "bfloat16"},
        # file key -> the port's ArchConfig, as port_arch must carry it
        {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
         "num_attention_heads": "n_heads",
         "num_key_value_heads": "n_kv_heads", "vocab_size": "vocab",
         "num_experts": "moe.n_experts", "num_experts_per_tok": "moe.top_k",
         "moe_intermediate_size": "moe.d_expert",
         "shared_expert_intermediate_size": "moe.d_shared",
         "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
         "tie_word_embeddings": "tie_embeddings",
         "torch_dtype": "param_dtype"},
        ("norm_topk_prob", False)),
    "ssm": (SSM_LAYOUT, {
        "port_arch": "mamba2-1.3b", "layout": "t_mamba2",
        "model_type": "mamba2", "num_hidden_layers": 2, "hidden_size": 64,
        "state_size": 16, "conv_kernel": 4, "expand": 2, "head_dim": 16,
        "num_heads": 8, "n_groups": 1, "chunk_size": 32, "vocab_size": 256,
        "layer_norm_epsilon": 1e-5, "use_bias": False,
        "use_conv_bias": True, "tie_word_embeddings": True,
        "torch_dtype": "bfloat16"},
        {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
         "vocab_size": "vocab", "state_size": "ssm.d_state",
         "conv_kernel": "ssm.d_conv", "expand": "ssm.expand",
         "head_dim": "ssm.head_dim", "chunk_size": "ssm.chunk",
         "n_groups": "ssm.ngroups", "num_heads": "n_ssm_heads",
         "layer_norm_epsilon": "norm_eps",
         "tie_word_embeddings": "tie_embeddings",
         "torch_dtype": "param_dtype"},
        ("use_bias", True)),
}
# leaves the port's own init leaves at ones or zeros: each one drawn here
# has to reach the logits, so that a program that skipped it would show
NEUTRAL = {"moe": {"bq": 0.0, "bv": 0.0, "ln1": 1.0},
           "ssm": {"D": 1.0, "dt_bias": 0.0, "conv_bx": 0.0,
                   "conv_bbc": 0.0, "norm_w": 1.0}}

# appended to a layout's text: the same layout with one leaf wrong
ONE_WRONG_SHAPE = '''

_right = leaf_shapes


def leaf_shapes(cfg):
    out = _right(cfg)
    (d,), kind = out["final_ln"]
    out["final_ln"] = ((d + 1,), kind)
    return out
'''
A_LOG_IN_BF16 = '''

_right = leaf_shapes


def leaf_shapes(cfg):
    out = _right(cfg)
    shape, kind, _ = out["seg0"]["A_log"]
    out["seg0"]["A_log"] = (shape, kind)
    return out
'''


def _family(tmp_path, family, extra_source="", **changes):
    source, cfg, _, _ = FAMILIES[family]
    cfg = dict(cfg, **changes)
    bench = tiny.layout_config(tmp_path, f"t-{family}", cfg,
                               source + extra_source)
    return bench.config(f"t-{family}")


def _get(arch, path):
    for name in path.split("."):
        arch = getattr(arch, name)
    return arch


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_non_dense_configuration_by_files_alone(tmp_path, family):
    from repro_torch.models.model import LM
    cfg = _family(tmp_path, family)
    lay = spec.layout(cfg)
    assert lay is not None and lay.__file__.startswith(str(tmp_path))
    arch = serve.port_arch(cfg)
    for key, field in FAMILIES[family][2].items():
        assert _get(arch, field) == cfg[key], key
    weights = serve.make_weights(cfg, 2**31 + 5, "cpu")
    serve.check_layout(arch, weights)
    for name, t in _leaves(weights):
        assert bool(torch.isfinite(t).all()), name
        assert not bool((t == 0).all()) and not bool((t == 1).all()), name
    if family == "ssm":
        a_log = weights["seg0"]["A_log"]
        assert a_log.dtype == torch.float32
        assert 0.0 <= float(a_log.min()) and float(a_log.max()) <= \
            math.log(16.0)
    # the counts of work come from the layout module
    n_attn = arch.n_attn_layers
    assert work.attn_layers(cfg) == lay.attn_layers(cfg) == n_attn
    assert work.token_flops(cfg) == lay.token_flops(cfg) > 0
    assert (work.attn_flops(cfg, 10) > 0) == (n_attn > 0)
    assert work.decode_flops(cfg, 2, 30) > 0
    o = types.SimpleNamespace(
        cfg=cfg, span_steps=lambda: [Step(0, 0, 1, "decode", tokens=2,
                                          context=50)],
        cell=types.SimpleNamespace(workload={"engine": {
            "max_pages_per_seq": 8, "prefill_chunk": 16}}))
    assert len(readings.paged_decode_bounds(o)) == n_attn

    model = LM(arch, device="cpu")
    tokens = torch.randint(2, cfg["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    logits, _ = model.prefill(weights, tokens)
    assert logits.shape == (2, cfg["vocab_size"])
    assert bool(torch.isfinite(logits).all())
    for name, value in NEUTRAL[family].items():
        seg = dict(weights["seg0"])
        seg[name] = torch.full_like(seg[name], value)
        moved, _ = model.prefill(dict(weights, seg0=seg), tokens)
        assert float((moved - logits).abs().max()) > \
            1e-3 * float(logits.std()), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_wrong_shape_fails_the_layout_check(tmp_path, family):
    cfg = _family(tmp_path, family, ONE_WRONG_SHAPE)
    arch = serve.port_arch(cfg)
    with pytest.raises(ValueError, match="final_ln"):
        serve.check_layout(arch, serve.make_weights(cfg, 1, "cpu"))


def test_a_wrong_dtype_fails_the_layout_check(tmp_path):
    cfg = _family(tmp_path, "ssm", A_LOG_IN_BF16)
    weights = serve.make_weights(cfg, 1, "cpu")
    assert weights["seg0"]["A_log"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="A_log"):
        serve.check_layout(serve.port_arch(cfg), weights)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_scalar_the_port_does_not_run_fails_port_arch(tmp_path, family):
    key, value = FAMILIES[family][3]
    cfg = _family(tmp_path, family, **{key: value})
    with pytest.raises(ValueError):
        serve.port_arch(cfg)


def test_a_layout_read_without_its_module_is_refused():
    cfg = dict(FAMILIES["ssm"][1])
    for fn in (serve.port_arch, serve.leaf_shapes, work.attn_layers,
               work.token_flops):
        with pytest.raises(LookupError, match="t_mamba2"):
            fn(cfg)


def test_the_counters_read_the_ssd_scan_launches(monkeypatch):
    from repro_torch.kernels.ssd_scan import ssd_scan
    counters = harness._counters()
    before = counters["ssd_scan"]()
    monkeypatch.setattr(ssd_scan, "launches", before + 3)
    assert counters["ssd_scan"]() == before + 3
