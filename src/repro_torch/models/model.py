"""The port's LM, from the reference's unified builder
(``repro.models.model.LM``), for every family: ``Family.DENSE``,
``AUDIO``, ``MOE``, ``SSM``, ``HYBRID`` and ``VLM``. A model is a list of
segments, each a stack of identical layers (a Python loop here,
``lax.scan`` in the reference):

  dense/audio:  [dense x L]
  moe:          [dense_mlp x n_dense, moe x (L - n_dense)]
  ssm:          [mamba x L]
  hybrid:       [hyb_super x n_super (inner mamba + one SHARED attention
                 + MLP block), mamba x trailing]
  vlm:          [vlm_super x n_super (inner dense + one cross-attention
                 layer)]

Parameters are a plain dict with the reference's leaf names and layout, so
one tree converts key for key (``repro_torch.convert``): embed (V, D),
final_ln (D,), head (D, V) unless tied, and seg<i> per segment, each leaf
stacked over layers as (L, ...); a hybrid super-block segment is
{"mamba": (n_super, inner, ...) leaves, "attn": one unstacked dense layer},
and a VLM super-block segment {"dense": (n_super, inner, ...) leaves,
"cross": (n_super, ...) leaves with tanh gates ``gate_attn`` and
``gate_mlp`` (1,), zero at init}.

Entry points, as in the reference: ``train_loss`` (full causal pass and a
chunked softmax cross-entropy, differentiable on the CPU and, through the
autograd Functions of kernels B2 and B3, on CUDA), ``prefill`` (full
pass; last-position logits and the staged caches), ``decode_step`` (one
token through every layer) and ``maybe_flush`` (recent -> big on every
attention cache; the caller runs it every ``recent_window`` steps). A
VLM's prefill takes the frontend's precomputed patch embeddings (B, T,
D) (``frontend=``; the
vision tower is the reference's stub) and its cache keeps their K/V for
decode. Everything runs in the parameter dtype (bf16 for the paper's
models), apart from the reference's promotions (an fp32 frontend gives
fp32 cross K/V). On CUDA attention prefill, self and cross, goes through
kernel B2, every norm through B3 and every Mamba-2 prefill through B4
(in training too, B4's backward a kernel as well);
the staged decode and the MoE routing and expert products
(``models/moe.py``) are plain torch, as the reference's are jnp.

Distribution comes from a ``Policy`` (``distributed/sharding.py``): each
template leaf carries its logical axes, ``param_specs`` and
``cache_specs`` resolve them, and under a policy with a mesh ``init`` and
``init_cache`` put each leaf on the mesh as a DTensor laid out by its
shape-aware spec (inputs likewise, ``_input``), the model's constraints
redistribute activations at the reference's sites, and every kernel runs
on each rank's local shard through ``local_map``. The entry points then
run under ``implicit_replication``: a plain tensor that every rank
computes alike (positions, masks, constants) joins DTensor ops as
replicated. ``init(None)`` builds uninitialised leaves from the template
alone, which the dry run (``launch/dryrun.py``) calls under
``FakeTensorMode``, as the reference's ``jax.eval_shape``."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Family, PosEmb
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (NO_POLICY, PSpec, Policy,
                                              mesh_axis_names, placements)
from repro_torch.models.attention import (RECENT_WINDOW, AttnCache,
                                          cross_attention_decode,
                                          cross_attention_full, flush_cache,
                                          self_attention_decode,
                                          self_attention_full)
from repro_torch.models.common import gated_mlp, rms_norm, sinusoidal_pos
from repro_torch.models.mamba2 import (MambaCache, make_mamba_cache,
                                       mamba_block_decode, mamba_block_full)
from repro_torch.models.moe import (moe_ffn, padded_experts,
                                    shared_expert_ffn)

# leaf = (shape, logical axes, scale); scale -1 -> ones, 0 -> zeros, -2 ->
# log U[1, 16] in fp32 (A_log), else N(0, scale^2)
Leaf = Tuple[Tuple[int, ...], Tuple[Optional[str], ...], float]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    kind: str                      # dense | dense_mlp | moe | mamba |
                                   # hyb_super | vlm_super
    n: int                         # layers (or super-blocks)
    inner: int = 1                 # mamba (hyb_super) or dense
                                   # (vlm_super) layers per super-block


def _attn_leaves(arch: ArchConfig) -> Dict[str, Leaf]:
    d = arch.d_model
    hd = arch.resolved_head_dim
    qd, kvd = arch.n_heads * hd, arch.n_kv_heads * hd
    s = 1.0 / math.sqrt(d)
    col, row = ("p_fsdp", "p_tp"), ("p_tp", "p_fsdp")
    leaves = {"wq": ((d, qd), col, s), "wk": ((d, kvd), col, s),
              "wv": ((d, kvd), col, s),
              "wo": ((qd, d), row, 1.0 / math.sqrt(qd))}
    if arch.qkv_bias:
        leaves.update({"bq": ((qd,), ("p_tp",), 0.0),
                       "bk": ((kvd,), ("p_tp",), 0.0),
                       "bv": ((kvd,), ("p_tp",), 0.0)})
    return leaves


def _mlp_leaves(arch: ArchConfig, d_ff: int) -> Dict[str, Leaf]:
    d = arch.d_model
    return {"wg": ((d, d_ff), ("p_fsdp", "p_tp"), 1.0 / math.sqrt(d)),
            "wu": ((d, d_ff), ("p_fsdp", "p_tp"), 1.0 / math.sqrt(d)),
            "wd": ((d_ff, d), ("p_tp", "p_fsdp"), 1.0 / math.sqrt(d_ff))}


def _norms(arch: ArchConfig) -> Dict[str, Leaf]:
    d = arch.d_model
    return {"ln1": ((d,), (None,), -1.0), "ln2": ((d,), (None,), -1.0)}


def _dense_layer_leaves(arch: ArchConfig, d_ff: int = 0) -> Dict[str, Leaf]:
    """A dense layer; ``d_ff`` (default: the arch's) sets the MLP width."""
    out = _norms(arch)
    out.update(_attn_leaves(arch))
    out.update(_mlp_leaves(arch, d_ff or arch.d_ff))
    return out


def _cross_layer_leaves(arch: ArchConfig) -> Dict[str, Leaf]:
    """A cross-attention layer: a dense layer's leaves and its two tanh
    gates, zero at init."""
    out = _norms(arch)
    out.update({"gate_attn": ((1,), (None,), 0.0),
                "gate_mlp": ((1,), (None,), 0.0)})
    out.update(_attn_leaves(arch))
    out.update(_mlp_leaves(arch, arch.d_ff))
    return out


def _moe_layer_leaves(arch: ArchConfig, ep: int) -> Dict[str, Leaf]:
    """Attention plus routed experts (stacked (E, ...), padded to a
    multiple of the expert-parallel degree ``ep``) and, where the arch has
    them, the shared experts' MLP."""
    d = arch.d_model
    m = arch.moe
    e = padded_experts(m.n_experts, ep)
    out = _norms(arch)
    out.update(_attn_leaves(arch))
    s = 1.0 / math.sqrt(d)
    out.update({"router": ((d, m.n_experts), (None, None), s),
                "w_gate": ((e, d, m.d_expert), ("experts", "p_fsdp", None),
                           s),
                "w_up": ((e, d, m.d_expert), ("experts", "p_fsdp", None), s),
                "w_down": ((e, m.d_expert, d), ("experts", None, "p_fsdp"),
                           1.0 / math.sqrt(m.d_expert))})
    if m.n_shared_experts:
        d_sh = m.d_shared or m.d_expert * m.n_shared_experts
        out.update({"sh_gate": ((d, d_sh), ("p_fsdp", "p_tp"), s),
                    "sh_up": ((d, d_sh), ("p_fsdp", "p_tp"), s),
                    "sh_down": ((d_sh, d), ("p_tp", "p_fsdp"),
                                1.0 / math.sqrt(d_sh))})
    return out


def _mamba_layer_leaves(arch: ArchConfig) -> Dict[str, Leaf]:
    d = arch.d_model
    s_cfg = arch.ssm
    di = arch.d_inner
    nh = arch.n_ssm_heads
    gn = s_cfg.ngroups * s_cfg.d_state
    s = 1.0 / math.sqrt(d)
    col = ("p_fsdp", "p_tp")
    return {"ln": ((d,), (None,), -1.0), "w_z": ((d, di), col, s),
            "w_x": ((d, di), col, s), "w_bc": ((d, 2 * gn), ("p_fsdp", None),
                                               s),
            "w_dt": ((d, nh), col, s), "dt_bias": ((nh,), ("p_tp",), 0.0),
            "conv_wx": ((s_cfg.d_conv, di), (None, "p_tp"), 0.5),
            "conv_bx": ((di,), ("p_tp",), 0.0),
            "conv_wbc": ((s_cfg.d_conv, 2 * gn), (None, None), 0.5),
            "conv_bbc": ((2 * gn,), (None,), 0.0),
            "A_log": ((nh,), ("p_tp",), -2.0),
            "D": ((nh,), ("p_tp",), -1.0),
            "norm_w": ((di,), ("p_tp",), -1.0),
            "w_out": ((di, d), ("p_tp", "p_fsdp"), 1.0 / math.sqrt(di))}


def _stack(leaves: Dict[str, Leaf], *ns: int) -> Dict[str, Leaf]:
    return {k: (tuple(ns) + shape, ("p_layers",) * len(ns) + axes, scale)
            for k, (shape, axes, scale) in leaves.items()}


def _is_leaf(node) -> bool:
    return isinstance(node, tuple) and len(node) == 3 \
        and isinstance(node[0], tuple)


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a template-shaped tree (nested dicts,
    lists, ``MambaCache``s and tuples of tensors or specs), and of ``rest``,
    shaped alike; a leaf is a tensor, a spec or a number."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, MambaCache):
        return MambaCache(*(_tree_map(fn, *ts) for ts in zip(
            tree.leaves(), *(r.leaves() for r in rest))))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PSpec):
        return type(tree)(_tree_map(fn, *ts) for ts in zip(tree, *rest))
    return fn(tree, *rest)


def _layer(seg: Dict[str, torch.Tensor], *idx: int) -> Dict[str, torch.Tensor]:
    return {k: t[idx] for k, t in seg.items()}


def _layers(seg: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """A stacked segment's per-layer leaves along its leading dim, as views
    from ``unbind``: under autograd each stacked leaf then gets one
    gradient, stacked once, not a full-size one per layer as indexing
    gives."""
    keys = list(seg)
    return [dict(zip(keys, ts))
            for ts in zip(*(seg[k].unbind(0) for k in keys))]


def _rows_whole(table: torch.Tensor) -> torch.Tensor:
    """An embedding table with its rows gathered where the vocab is
    sharded (FSDP): each rank then looks up its own tokens, where a
    row-sharded lookup has every rank embed the whole batch and reduce."""
    if not isinstance(table, DTensor):
        return table
    pl = [Replicate() if p.is_shard(0) else p for p in table.placements]
    return table.redistribute(table.device_mesh, pl)


def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A cross layer's tanh gate in x's type, taken in fp32 as the
    reference does."""
    return torch.tanh(g.float()).to(x.dtype)


# segment kinds whose layers hold one self-attention site each
_ATTN_KINDS = ("dense", "dense_mlp", "moe")


class LM:
    """``policy`` (default: none, one device) lays the model out on its
    mesh; ``capacity_factor`` (default: the arch's
    ``moe.capacity_factor``) sizes the MoE layers' static expert capacity,
    ``loss_chunk`` the sequence chunk of ``train_loss``'s cross-entropy,
    and ``remat`` runs each layer body of ``train_loss`` under activation
    checkpointing, as the reference's ``ExecConfig`` fields of those
    names do."""

    def __init__(self, arch: ArchConfig, policy: Policy = NO_POLICY,
                 device: DeviceLike = None,
                 recent_window: int = RECENT_WINDOW,
                 capacity_factor: Optional[float] = None,
                 loss_chunk: int = 512, remat: bool = False):
        self.arch = arch
        self.policy = policy
        self.device = resolve_device(device)
        self.recent_window = recent_window
        self.capacity_factor = capacity_factor
        self.loss_chunk = loss_chunk
        self.remat = remat
        self.dtype = torch.bfloat16 if arch.param_dtype == "bfloat16" \
            else torch.float32
        self.segments = self._build_segments()

    def _build_segments(self) -> List[SegmentSpec]:
        a = self.arch
        if a.family in (Family.DENSE, Family.AUDIO):
            return [SegmentSpec("dense", a.n_layers)]
        if a.family == Family.MOE:
            nd = a.moe.n_dense_layers
            segs = [SegmentSpec("dense_mlp", nd)] if nd else []
            return segs + [SegmentSpec("moe", a.n_layers - nd)]
        if a.family == Family.SSM:
            return [SegmentSpec("mamba", a.n_layers)]
        if a.family == Family.VLM:
            per = a.cross_attn_every
            if a.n_layers % per:
                raise ValueError(f"{a.name}: {a.n_layers} layers are not "
                                 f"super-blocks of {per}")
            return [SegmentSpec("vlm_super", a.n_layers // per,
                                inner=per - 1)]
        per = a.attn_every
        n_super = a.n_layers // per
        trailing = a.n_layers - n_super * per
        segs = [SegmentSpec("hyb_super", n_super, inner=per - 1)]
        if trailing:
            segs.append(SegmentSpec("mamba", trailing))
        return segs

    # -- distribution -------------------------------------------------------
    def replicating(self):
        """The context the entry points run under, and a backward through
        them must run under too: implicit replication under a mesh (a
        plain tensor joins DTensor ops as replicated), nothing without."""
        if self.policy.mesh is None:
            return contextlib.nullcontext()
        return implicit_replication()

    def _gathered(self, lp):
        """A layer's params with their FSDP axes ("p_fsdp") gathered where
        the layer runs (under remat again in its backward), as the
        reference gathers them layer by layer inside its scan: left
        sharded, DTensor may gather the activations instead. Without
        FSDP axes, ``lp``."""
        pol = self.policy
        if pol.mesh is None:
            return lp
        names = mesh_axis_names(pol.mesh)
        fsdp = {names.index(a) for a in pol.rules.get("p_fsdp", ())
                if a in names}
        if not fsdp:
            return lp

        def whole(t):
            if not isinstance(t, DTensor):
                return t
            pl = [Replicate() if i in fsdp else p
                  for i, p in enumerate(t.placements)]
            return t if pl == list(t.placements) \
                else t.redistribute(t.device_mesh, pl)
        return {k: whole(t) for k, t in lp.items()}

    def _input(self, t, logical):
        """An input every rank holds whole, laid out on the mesh by its
        shape-aware spec (a DTensor or None as it came)."""
        if t is None or isinstance(t, DTensor) or self.policy.mesh is None:
            return t
        return self.policy.distribute(t, logical)

    def _placed(self, tree, specs):
        """``tree`` (params or a cache) with each tensor leaf laid out by
        its spec: a DTensor redistributed, a plain tensor distributed.
        Without a mesh, ``tree``."""
        pol = self.policy
        if pol.mesh is None:
            return tree

        def place(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            pl = placements(spec, pol.mesh)
            if isinstance(t, DTensor):
                return t if tuple(t.placements) == pl \
                    else t.redistribute(pol.mesh, pl)
            return distribute_tensor(t, pol.mesh, pl, src_data_rank=None)
        return _tree_map(place, tree, specs)

    # -- parameters ---------------------------------------------------------
    def param_template(self) -> Dict[str, object]:
        """Nested dicts of leaves (shape, logical axes, scale), the
        reference's layout and axes; MoE experts padded to a multiple of
        the policy's expert-parallel degree."""
        a = self.arch
        ep = self.policy.axis_size("experts")
        d = a.d_model
        t: Dict[str, object] = {"embed": ((a.vocab, d), ("p_fsdp", None),
                                          0.02),
                                "final_ln": ((d,), (None,), -1.0)}
        if not a.tie_embeddings:
            t["head"] = ((d, a.vocab), ("p_fsdp", "vocab"),
                         1.0 / math.sqrt(d))
        for i, seg in enumerate(self.segments):
            if seg.kind == "dense":
                t[f"seg{i}"] = _stack(_dense_layer_leaves(a), seg.n)
            elif seg.kind == "dense_mlp":    # leading dense layers of a MoE
                dff = a.moe.d_shared or a.moe.d_expert * 8
                t[f"seg{i}"] = _stack(_dense_layer_leaves(a, dff), seg.n)
            elif seg.kind == "moe":
                t[f"seg{i}"] = _stack(_moe_layer_leaves(a, ep), seg.n)
            elif seg.kind == "mamba":
                t[f"seg{i}"] = _stack(_mamba_layer_leaves(a), seg.n)
            elif seg.kind == "hyb_super":
                t[f"seg{i}"] = {
                    "mamba": _stack(_mamba_layer_leaves(a), seg.n, seg.inner),
                    "attn": _dense_layer_leaves(a)}
            else:
                t[f"seg{i}"] = {
                    "dense": _stack(_dense_layer_leaves(a), seg.n, seg.inner),
                    "cross": _stack(_cross_layer_leaves(a), seg.n)}
        return t

    def _template_map(self, fn):
        def walk(node):
            return {k: walk(node[k]) if not _is_leaf(node[k])
                    else fn(*node[k]) for k in sorted(node)}
        return walk(self.param_template())

    def param_specs(self):
        """A spec tree matching ``init``'s, shape-aware (axes that do not
        divide a dim are dropped, as parameters are laid out evenly)."""
        pol = self.policy
        return self._template_map(
            lambda shape, axes, _: pol.spec_for_shape(axes, shape))

    def init(self, generator: Optional[torch.Generator]
             ) -> Dict[str, object]:
        """Random weights as the reference's ``init`` draws them (normal
        times the leaf's scale, ones for norms and D, zeros for biases,
        log U[1, 16] in fp32 for A_log), from ``generator`` on the
        generator's device, stored on this model's device in its dtype;
        leaves are drawn in sorted key order. Under a mesh each rank draws
        every leaf and keeps its own shard. With ``generator`` None the
        leaves are uninitialised (``torch.empty``; A_log fp32), for a trace
        under ``FakeTensorMode``."""
        dev = self.device

        def make(shape, axes, scale):
            if generator is None:
                t = torch.empty(shape, device=dev, dtype=torch.float32
                                if scale == -2.0 else self.dtype)
            elif scale == -1.0:
                t = torch.ones(shape, dtype=self.dtype, device=dev)
            elif scale == 0.0:
                t = torch.zeros(shape, dtype=self.dtype, device=dev)
            elif scale == -2.0:
                u = torch.rand(shape, generator=generator,
                               dtype=torch.float32, device=generator.device)
                t = torch.log(u * 15.0 + 1.0).to(dev)
            else:
                t = torch.randn(shape, generator=generator,
                                dtype=torch.float32,
                                device=generator.device)
                t = t.mul_(scale).to(device=dev, dtype=self.dtype)
            return self.policy.distribute(t, axes)
        return self._template_map(make)

    def place_params(self, params):
        """A whole params tree (every rank holds the same, e.g. converted
        from the reference's) laid out on the policy's mesh by
        ``param_specs``: each rank keeps its own shards, nothing is sent.
        Without a mesh, ``params``."""
        return self._placed(params, self.param_specs())

    def head_weight(self, params) -> torch.Tensor:
        if self.arch.tie_embeddings:
            return params["embed"].T
        return params["head"]

    # -- layer bodies -------------------------------------------------------
    def _dense_layer_full(self, x, p, positions, return_cache=True):
        a, pol = self.arch, self.policy
        h = rms_norm(x, p["ln1"], a.norm_eps)
        res = self_attention_full(h, p, a, pol, positions=positions,
                                  return_kv=return_cache)
        res, kv = res if return_cache else (res, None)
        x = x + res
        h = rms_norm(x, p["ln2"], a.norm_eps)
        h = gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
        return x + pol.constrain(h, ("batch", "seq_q", None)), kv

    def _dense_layer_decode(self, x, p, cache: AttnCache):
        a = self.arch
        h = rms_norm(x, p["ln1"], a.norm_eps)
        res, cache = self_attention_decode(h, cache, p, a, self.policy)
        x = x + res
        h = rms_norm(x, p["ln2"], a.norm_eps)
        return x + gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act), cache

    def _moe_layer_full(self, x, p, positions, return_cache=True):
        a = self.arch
        h = rms_norm(x, p["ln1"], a.norm_eps)
        res = self_attention_full(h, p, a, self.policy, positions=positions,
                                  return_kv=return_cache)
        res, kv = res if return_cache else (res, None)
        x = x + res
        h = rms_norm(x, p["ln2"], a.norm_eps)
        out, aux = moe_ffn(h, p, a, self.policy, self.capacity_factor)
        if a.moe.n_shared_experts:
            out = out + shared_expert_ffn(h, p, a)
        return x + out, kv, aux

    def _moe_layer_decode(self, x, p, cache: AttnCache):
        a = self.arch
        h = rms_norm(x, p["ln1"], a.norm_eps)
        res, cache = self_attention_decode(h, cache, p, a, self.policy)
        x = x + res
        h = rms_norm(x, p["ln2"], a.norm_eps)
        out, aux = moe_ffn(h[:, None, :], p, a, self.policy,
                           self.capacity_factor)
        out = out[:, 0]
        if a.moe.n_shared_experts:
            out = out + shared_expert_ffn(h, p, a)
        return x + out, cache, aux

    def _cross_layer_full(self, x, p, frontend, return_cache=True):
        a = self.arch
        h = rms_norm(x, p["ln1"], a.norm_eps)
        res = cross_attention_full(h, frontend, p, a, self.policy,
                                   return_kv=return_cache)
        res, kv = res if return_cache else (res, None)
        x = x + _gate(p["gate_attn"], x) * res
        h = rms_norm(x, p["ln2"], a.norm_eps)
        h = gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
        return x + _gate(p["gate_mlp"], x) * h, kv

    def _cross_layer_decode(self, x, p, cross_kv):
        a = self.arch
        h = rms_norm(x, p["ln1"], a.norm_eps)
        res = cross_attention_decode(h, cross_kv, p, a, self.policy)
        x = x + _gate(p["gate_attn"], x) * res
        h = rms_norm(x, p["ln2"], a.norm_eps)
        h = gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
        return x + _gate(p["gate_mlp"], x) * h

    def _mamba_layer_full(self, x, p, return_cache=True):
        h = rms_norm(x, p["ln"], self.arch.norm_eps)
        res = mamba_block_full(h, p, self.arch, self.policy,
                               return_cache=return_cache)
        res, cache = res if return_cache else (res, None)
        return x + res, cache

    def _mamba_layer_decode(self, x, p, cache: MambaCache):
        h = rms_norm(x, p["ln"], self.arch.norm_eps)
        res, cache = mamba_block_decode(h, cache, p, self.arch, self.policy)
        return x + res, cache

    # -- full-sequence forward ------------------------------------------------
    def _embed_inputs(self, params, tokens=None, embeds=None):
        a = self.arch
        if embeds is None:
            # F.embedding, not indexing: the same rows, and on the CPU its
            # backward sums a repeated token's rows in a fixed order
            # (indexing's accumulates them in parallel, in any order)
            embeds = F.embedding(self._input(tokens, ("batch", None)),
                                 _rows_whole(params["embed"]))
            if a.tie_embeddings:
                embeds = embeds * math.sqrt(a.d_model)
        else:
            embeds = self._input(embeds, ("batch", None, None))
        x = embeds.to(self.dtype)
        if a.pos_emb == PosEmb.SINUSOIDAL:
            positions = torch.arange(x.shape[1], device=x.device)
            x = x + sinusoidal_pos(positions, a.d_model).to(x.dtype)
        return self.policy.constrain(x, ("batch", None, None))

    def _forward_full(self, params, x, frontend=None, return_cache=True):
        """x: (B, S, D) -> (final-normed hidden (B, S, D), per-segment raw
        caches: (k, v) stacks, stacked MambaCaches, or both, or a VLM's
        dense (k, v) stacks and cross (k, v); aux (2,) fp32: the MoE
        layers' [load-balance loss, drops] summed). ``frontend`` (B, T, D)
        feeds a VLM's cross-attention layers. Without ``return_cache``
        (``train_loss``) no cache is built and each segment's entry is
        None; with ``remat`` each layer body runs under activation
        checkpointing."""
        positions = torch.arange(x.shape[1], device=x.device)
        rc = return_cache

        def run(body, y, lp, *args):
            def layer(y_, lp_, *a):
                return body(y_, self._gathered(lp_), *a)
            if self.remat:
                return checkpoint(layer, y, lp, *args, use_reentrant=False)
            return layer(y, lp, *args)

        def dense(y, lp):
            return run(self._dense_layer_full, y, lp, positions, rc)

        def mamba(y, lp):
            return run(self._mamba_layer_full, y, lp, rc)

        def stacked(pairs):
            """(k, v) of each attention layer -> stacked (k, v), or None
            without caches."""
            if not rc:
                return None
            return tuple(torch.stack(t) for t in zip(*pairs))

        caches = []
        aux_sum = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for i, seg in enumerate(self.segments):
            p = params[f"seg{i}"]
            if seg.kind in _ATTN_KINDS:
                kvs = []
                for lp in _layers(p):
                    if seg.kind == "moe":
                        x, kv, aux = run(self._moe_layer_full, x, lp,
                                         positions, rc)
                        aux_sum = aux_sum + aux
                    else:
                        x, kv = dense(x, lp)
                    kvs.append(kv)
                caches.append(stacked(kvs))
            elif seg.kind == "mamba":
                mcs = []
                for lp in _layers(p):
                    x, c = mamba(x, lp)
                    mcs.append(c)
                caches.append(MambaCache.stack(mcs) if rc else None)
            elif seg.kind == "vlm_super":
                dkvs, ckvs = [], []
                for dp, cp in zip(_layers(p["dense"]), _layers(p["cross"])):
                    kvs = []
                    for lp in _layers(dp):
                        x, kv = dense(x, lp)
                        kvs.append(kv)
                    dkvs.append(stacked(kvs))
                    x, kv = run(self._cross_layer_full, x, cp, frontend, rc)
                    ckvs.append(kv)
                caches.append((stacked(dkvs), stacked(ckvs)) if rc
                              else None)
            else:
                supers, kvs = [], []
                for sp in _layers(p["mamba"]):
                    inner = []
                    for lp in _layers(sp):
                        x, c = mamba(x, lp)
                        inner.append(c)
                    supers.append(MambaCache.stack(inner) if rc else None)
                    x, kv = dense(x, p["attn"])
                    kvs.append(kv)
                caches.append((MambaCache.stack(supers), stacked(kvs))
                              if rc else None)
        return (rms_norm(x, params["final_ln"], self.arch.norm_eps), caches,
                aux_sum)

    # -- training loss --------------------------------------------------------
    def train_loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """batch: {"tokens" (B, S) int64 | "embeds" (B, S, D), "labels" (B,
        S), and a VLM's "frontend" (B, T, D)} -> (loss, metrics {"xent",
        "lb_loss", "moe_drops"}), fp32 scalars. Labels < 0 are masked. The
        cross-entropy goes over sequence chunks of ``loss_chunk`` (the
        whole sequence when it does not divide S); each chunk's logits are
        the fp32 product of the bf16 hidden state and head, which is exact
        in fp32 as the reference's ``preferred_element_type=float32``
        product, and are never rounded to bf16. For MoE the loss adds
        0.01 * lb_loss / n_layers."""
        with self.replicating():
            return self._train_loss(params, batch)

    def _train_loss(self, params, batch):
        pol = self.policy
        x = self._embed_inputs(params, batch.get("tokens"),
                               batch.get("embeds"))
        h, _, aux = self._forward_full(
            params, x, self._input(batch.get("frontend"),
                                   ("batch", None, None)),
            return_cache=False)
        h = pol.constrain(h, ("batch", None, None))
        labels = self._input(batch["labels"], ("batch", None))
        # the head gathered over its FSDP axes in bf16, as the reference
        # keeps it through the gathered product: left sharded over the
        # batch's axes, the product would shard the vocab instead and
        # gather every rank's logits
        w = pol.constrain(self.head_weight(params), (None, "vocab")).float()
        b, s, d = h.shape
        chunk = min(self.loss_chunk or s, s)
        if s % chunk:
            chunk = s
        vocab = torch.arange(w.shape[1], device=h.device)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int64, device=h.device)
        for c0 in range(0, s, chunk):
            lc = labels[:, c0:c0 + chunk]
            logits = pol.constrain(h[:, c0:c0 + chunk].float() @ w,
                                   ("batch", None, "vocab"))
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.where(lc[..., None] == vocab, logits, 0.0).sum(-1)
            mask = lc >= 0
            tot = tot + torch.where(mask, lse - tgt, 0.0).sum()
            cnt = cnt + mask.sum()
        loss = tot / torch.clamp_min(cnt, 1)
        metrics = {"xent": loss, "lb_loss": aux[0], "moe_drops": aux[1]}
        if self.arch.moe is not None:
            loss = loss + 0.01 * aux[0] / max(self.arch.n_layers, 1)
        return loss, metrics

    # -- prefill ------------------------------------------------------------
    def prefill(self, params, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                s_max: Optional[int] = None,
                logit_pos: Optional[int] = None, return_aux: bool = False,
                frontend: Optional[torch.Tensor] = None):
        """tokens: (B, S) int64, or embeds: (B, S, D) (``Family.AUDIO``) ->
        (logits (B, V) fp32 at ``logit_pos`` (default: last), cache), and
        with ``return_aux`` a third item, the MoE layers' summed (2,) fp32
        [load-balance loss, dropped assignments] (zeros without MoE). A
        VLM needs ``frontend``, the patch embeddings (B, T, D).

        The cache has one entry per segment: an attention dict {k_big,
        v_big (L, B, s_max, Hkv, hd) padded from S, k_rec, v_rec (L, B, W,
        Hkv, hd) zeros, big_len = S, rec_len = 0}, a stacked MambaCache,
        {"mamba", "attn"} for a hybrid super-block segment, or {"dense":
        an attention dict with leading dims (n_super, inner), "cross_kv":
        (k, v) each (n_super, B, T, Hkv, hd)} for a VLM's.

        ``logit_pos`` supports length-bucketed prefill of attention-only
        models (causal attention makes tail padding inert); tail padding
        would enter an SSM's state, so SSM prompts are never padded."""
        if frontend is None and any(g.kind == "vlm_super"
                                    for g in self.segments):
            raise ValueError(f"{self.arch.name}: prefill needs frontend=")
        with self.replicating():
            x = self._embed_inputs(params, tokens, embeds)
            b, s, _ = x.shape
            s_max = s_max or s
            frontend = self._input(frontend, ("batch", None, None))
            h, raw, aux = self._forward_full(params, x, frontend)
            pos = s - 1 if logit_pos is None else logit_pos
            logits = h[:, pos].float() @ self.head_weight(params).float()
            cache = self._package_cache(
                raw, b, s, s_max, frontend.shape[1] if frontend is not None
                else 0)
        return (logits, cache, aux) if return_aux else (logits, cache)

    def _attn_cache_from_kv(self, kv, b, s, s_max):
        a = self.arch

        def big(t):                              # (..., B, s_max, Hkv, hd)
            t = t.to(self.dtype)
            if s_max == s:
                return t
            if isinstance(t, DTensor):
                # padding a sequence-sharded dim moves every shard's
                # positions: gather the sequence (no measured path pads)
                t = t.redistribute(t.device_mesh, [
                    Replicate() if pl == Shard(t.ndim - 3) else pl
                    for pl in t.placements])
            return F.pad(t, (0, 0, 0, 0, 0, s_max - s))
        k, v = big(kv[0]), big(kv[1])
        rec = torch.zeros(k.shape[:-4] + (b, self.recent_window,
                                          a.n_kv_heads, a.resolved_head_dim),
                          dtype=self.dtype, device=k.device)
        return {"k_big": k, "v_big": v, "k_rec": rec, "v_rec": rec.clone(),
                "big_len": s, "rec_len": 0}

    def _package_cache(self, raw, b, s, s_max, frontend_tokens=0):
        """The prefill's per-segment caches, laid out by ``cache_specs``."""
        out = []
        for seg, c in zip(self.segments, raw):
            if seg.kind in _ATTN_KINDS:
                out.append(self._attn_cache_from_kv(c, b, s, s_max))
            elif seg.kind == "mamba":
                out.append(c)
            elif seg.kind == "hyb_super":
                mcs, kv = c
                out.append({"mamba": mcs,
                            "attn": self._attn_cache_from_kv(kv, b, s,
                                                             s_max)})
            else:
                kvs, ckv = c
                out.append({"dense": self._attn_cache_from_kv(kvs, b, s,
                                                              s_max),
                            "cross_kv": ckv})
        return self._placed(out, self.cache_specs(b, s_max, frontend_tokens))

    def init_cache(self, batch: int, s_max: int, frontend_tokens: int = 0):
        """Zero cache (fresh generation), laid out by ``cache_specs``; a
        VLM's cross K/V hold ``frontend_tokens`` (default: the arch's
        ``n_frontend_tokens``)."""
        a = self.arch
        hd = a.resolved_head_dim
        dev = self.device

        def attn_cache(*lead):
            def z(n):
                return torch.zeros(lead + (batch, n, a.n_kv_heads, hd),
                                   dtype=self.dtype, device=dev)
            return {"k_big": z(s_max), "v_big": z(s_max),
                    "k_rec": z(self.recent_window),
                    "v_rec": z(self.recent_window),
                    "big_len": 0, "rec_len": 0}

        def mamba_cache(*lead):
            return make_mamba_cache(batch, a, dev).map(
                lambda t: t.expand(lead + t.shape).clone())

        out = []
        for seg in self.segments:
            if seg.kind in _ATTN_KINDS:
                out.append(attn_cache(seg.n))
            elif seg.kind == "mamba":
                out.append(mamba_cache(seg.n))
            elif seg.kind == "hyb_super":
                out.append({"mamba": mamba_cache(seg.n, seg.inner),
                            "attn": attn_cache(seg.n)})
            else:
                nf = frontend_tokens or a.n_frontend_tokens

                def z():
                    return torch.zeros((seg.n, batch, nf, a.n_kv_heads, hd),
                                       dtype=self.dtype, device=dev)
                out.append({"dense": attn_cache(seg.n, seg.inner),
                            "cross_kv": (z(), z())})
        return self._placed(out, self.cache_specs(batch, s_max,
                                                  frontend_tokens))

    def cache_specs(self, batch: int, s_max: int, frontend_tokens: int = 0):
        """A spec tree matching ``init_cache(batch, s_max,
        frontend_tokens)`` leaf for leaf (shape-aware; the lengths, plain
        ints here, get ``PSpec()`` as the reference's scalars): the big
        K/V sequence-sharded, the recent buffer batch-sharded alone."""
        a = self.arch
        pol = self.policy
        hd = a.resolved_head_dim
        w = self.recent_window

        def attn_spec(*lead):
            nl = (None,) * len(lead)
            big = pol.spec_for_shape(nl + ("batch", "kv_seq", None, None),
                                     lead + (batch, s_max, a.n_kv_heads, hd))
            rec = pol.spec_for_shape(nl + ("batch", None, None, None),
                                     lead + (batch, w, a.n_kv_heads, hd))
            return {"k_big": big, "v_big": big, "k_rec": rec, "v_rec": rec,
                    "big_len": PSpec(), "rec_len": PSpec()}

        def mamba_spec(*lead):
            nl = (None,) * len(lead)
            s_cfg = a.ssm
            return MambaCache(
                ssm_state=pol.spec_for_shape(
                    nl + ("batch", "ssm_heads", None, None),
                    lead + (batch, a.n_ssm_heads, s_cfg.head_dim,
                            s_cfg.d_state)),
                conv_x=pol.spec_for_shape(
                    nl + ("batch", None, "d_inner"),
                    lead + (batch, s_cfg.d_conv - 1, a.d_inner)),
                conv_bc=pol.spec_for_shape(
                    nl + ("batch", None, None),
                    lead + (batch, s_cfg.d_conv - 1,
                            2 * s_cfg.ngroups * s_cfg.d_state)))

        out = []
        for seg in self.segments:
            if seg.kind in _ATTN_KINDS:
                out.append(attn_spec(seg.n))
            elif seg.kind == "mamba":
                out.append(mamba_spec(seg.n))
            elif seg.kind == "hyb_super":
                out.append({"mamba": mamba_spec(seg.n, seg.inner),
                            "attn": attn_spec(seg.n)})
            else:
                nf = frontend_tokens or a.n_frontend_tokens
                ckv = pol.spec_for_shape(
                    (None, "batch", "frontend_seq", None, None),
                    (seg.n, batch, nf, a.n_kv_heads, hd))
                out.append({"dense": attn_spec(seg.n, seg.inner),
                            "cross_kv": (ckv, ckv)})
        return out

    # -- decode -------------------------------------------------------------
    @staticmethod
    def _unpack_attn(c, idx=None) -> AttnCache:
        def sel(t):
            return t if idx is None else t[idx]
        return AttnCache(k_big=sel(c["k_big"]), v_big=sel(c["v_big"]),
                         k_recent=sel(c["k_rec"]), v_recent=sel(c["v_rec"]),
                         big_len=c["big_len"], recent_len=c["rec_len"])

    @staticmethod
    def _appended(c, sites: List[AttnCache]):
        """Stacked cache ``c`` after one decode step through ``sites``, in
        the order of its leading dims."""
        shape = c["k_rec"].shape
        return {**c,
                "k_rec": torch.stack([a.k_recent for a in sites])
                .reshape(shape),
                "v_rec": torch.stack([a.v_recent for a in sites])
                .reshape(shape),
                "rec_len": c["rec_len"] + 1}

    def decode_step(self, params, cache, tokens: torch.Tensor,
                    return_aux: bool = False):
        """tokens: (B,) int64 -> (logits (B, V) fp32, new cache), and the
        summed MoE aux with ``return_aux`` (as ``prefill``). The input
        cache is left as it was."""
        with self.replicating():
            return self._decode_step(params, cache, tokens, return_aux)

    def _decode_step(self, params, cache, tokens, return_aux):
        a, pol = self.arch, self.policy
        x = F.embedding(self._input(tokens, ("batch",)),
                        _rows_whole(params["embed"])).to(self.dtype)
        if a.tie_embeddings:
            x = x * math.sqrt(a.d_model)
        if a.pos_emb == PosEmb.SINUSOIDAL:
            c0 = cache[0]
            pos = torch.tensor([c0["big_len"] + c0["rec_len"]],
                               device=x.device)
            x = x + sinusoidal_pos(pos, a.d_model)[0].to(x.dtype)
        x = pol.constrain(x, ("batch", None))
        new_cache = []
        aux_sum = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for i, seg in enumerate(self.segments):
            p, c = params[f"seg{i}"], cache[i]
            if seg.kind in _ATTN_KINDS:
                sites = []
                for li in range(seg.n):
                    if seg.kind == "moe":
                        x, ac, aux = self._moe_layer_decode(
                            x, self._gathered(_layer(p, li)),
                            self._unpack_attn(c, li))
                        aux_sum = aux_sum + aux
                    else:
                        x, ac = self._dense_layer_decode(
                            x, self._gathered(_layer(p, li)),
                            self._unpack_attn(c, li))
                    sites.append(ac)
                new_cache.append(self._appended(c, sites))
            elif seg.kind == "mamba":
                ncs = []
                for li in range(seg.n):
                    x, m = self._mamba_layer_decode(
                        x, self._gathered(_layer(p, li)),
                        c.map(lambda t: t[li]))
                    ncs.append(m)
                new_cache.append(MambaCache.stack(ncs))
            elif seg.kind == "vlm_super":
                cd, sites = c["dense"], []
                for si in range(seg.n):
                    for j in range(seg.inner):
                        x, ac = self._dense_layer_decode(
                            x, self._gathered(_layer(p["dense"], si, j)),
                            self._unpack_attn(cd, (si, j)))
                        sites.append(ac)
                    x = self._cross_layer_decode(
                        x, self._gathered(_layer(p["cross"], si)),
                        tuple(t[si] for t in c["cross_kv"]))
                new_cache.append({"dense": self._appended(cd, sites),
                                  "cross_kv": c["cross_kv"]})
            else:
                supers, sites = [], []
                for si in range(seg.n):
                    inner = []
                    for j in range(seg.inner):
                        x, m = self._mamba_layer_decode(
                            x, self._gathered(_layer(p["mamba"], si, j)),
                            c["mamba"].map(lambda t: t[si, j]))
                        inner.append(m)
                    supers.append(MambaCache.stack(inner))
                    x, ac = self._dense_layer_decode(
                        x, self._gathered(p["attn"]),
                        self._unpack_attn(c["attn"], si))
                    sites.append(ac)
                new_cache.append({"mamba": MambaCache.stack(supers),
                                  "attn": self._appended(c["attn"], sites)})
        x = rms_norm(x, params["final_ln"], a.norm_eps)
        logits = pol.constrain(x.float() @ self.head_weight(params).float(),
                               ("batch", "vocab"))
        return (logits, new_cache, aux_sum) if return_aux \
            else (logits, new_cache)

    def maybe_flush(self, cache):
        """Flush recent -> big on every attention cache (run it every
        ``recent_window`` decode steps, before the buffer overflows)."""
        with self.replicating():
            return self._flush(cache)

    def _flush(self, cache):
        def flush_attn(c):
            nc = flush_cache(self._unpack_attn(c))
            return {"k_big": nc.k_big, "v_big": nc.v_big,
                    "k_rec": nc.k_recent, "v_rec": nc.v_recent,
                    "big_len": nc.big_len, "rec_len": nc.recent_len}

        out = []
        for seg, c in zip(self.segments, cache):
            if seg.kind in _ATTN_KINDS:
                out.append(flush_attn(c))
            elif seg.kind == "mamba":
                out.append(c)
            elif seg.kind == "hyb_super":
                out.append({"mamba": c["mamba"],
                            "attn": flush_attn(c["attn"])})
            else:
                out.append({"dense": flush_attn(c["dense"]),
                            "cross_kv": c["cross_kv"]})
        return out
