"""Dense LM of the port (``Family.DENSE`` and ``Family.AUDIO``): the part of
the reference's unified builder (``repro.models.model.LM``) that the serving
engine runs.

Parameters are a plain dict with the reference's leaf names and layout, so
one tree converts key for key (``repro_torch.convert``):

  embed (V, D), final_ln (D,), head (D, V) unless tied, and
  seg0 = {ln1, ln2, wq, wk, wv, wo, [bq, bk, bv], wg, wu, wd}, each leaf
  stacked over layers as (L, ...).

``prefill`` runs in the parameter dtype (bf16 for the paper's models), as
the reference does; attention goes through kernel B2 and every norm
through kernel B3 on CUDA. The staged-cache ``decode_step`` is not ported:
the engine decodes through the paged kernel."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, Family, PosEmb
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import self_attention_full
from repro_torch.models.common import gated_mlp, rms_norm, sinusoidal_pos

# leaf = (shape, scale); scale -1 -> ones, 0 -> zeros, else N(0, scale^2)
Leaf = Tuple[Tuple[int, ...], float]


def _attn_leaves(arch: ArchConfig) -> Dict[str, Leaf]:
    d = arch.d_model
    hd = arch.resolved_head_dim
    qd, kvd = arch.n_heads * hd, arch.n_kv_heads * hd
    s = 1.0 / math.sqrt(d)
    leaves = {"wq": ((d, qd), s), "wk": ((d, kvd), s), "wv": ((d, kvd), s),
              "wo": ((qd, d), 1.0 / math.sqrt(qd))}
    if arch.qkv_bias:
        leaves.update({"bq": ((qd,), 0.0), "bk": ((kvd,), 0.0),
                       "bv": ((kvd,), 0.0)})
    return leaves


def _dense_layer_leaves(arch: ArchConfig) -> Dict[str, Leaf]:
    d, dff = arch.d_model, arch.d_ff
    out = {"ln1": ((d,), -1.0), "ln2": ((d,), -1.0)}
    out.update(_attn_leaves(arch))
    out.update({"wg": ((d, dff), 1.0 / math.sqrt(d)),
                "wu": ((d, dff), 1.0 / math.sqrt(d)),
                "wd": ((dff, d), 1.0 / math.sqrt(dff))})
    return out


class LM:
    def __init__(self, arch: ArchConfig, device: DeviceLike = None):
        if arch.family not in (Family.DENSE, Family.AUDIO):
            raise NotImplementedError(
                "repro_torch ports the dense/audio LM only, not "
                f"{arch.family.value}")
        self.arch = arch
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if arch.param_dtype == "bfloat16" \
            else torch.float32

    # -- parameters ---------------------------------------------------------
    def param_template(self) -> Dict[str, object]:
        a = self.arch
        d = a.d_model
        t: Dict[str, object] = {"embed": ((a.vocab, d), 0.02),
                                "final_ln": ((d,), -1.0)}
        if not a.tie_embeddings:
            t["head"] = ((d, a.vocab), 1.0 / math.sqrt(d))
        t["seg0"] = {k: ((a.n_layers,) + shape, scale)
                     for k, (shape, scale) in _dense_layer_leaves(a).items()}
        return t

    def init(self, generator: torch.Generator) -> Dict[str, object]:
        """Random weights as the reference's ``init`` draws them (normal
        times the leaf's scale, ones for norms, zeros for biases), from
        ``generator`` on the generator's device, stored on this model's
        device in its dtype. Leaves are drawn in sorted key order."""
        gdev = generator.device

        def make(shape, scale):
            if scale == -1.0:
                return torch.ones(shape, dtype=self.dtype, device=self.device)
            if scale == 0.0:
                return torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=gdev)
            return (t * scale).to(device=self.device, dtype=self.dtype)

        def walk(node):
            return {k: walk(node[k]) if isinstance(node[k], dict)
                    else make(*node[k]) for k in sorted(node)}
        return walk(self.param_template())

    # -- prefill ------------------------------------------------------------
    def head_weight(self, params) -> torch.Tensor:
        if self.arch.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def prefill(self, params, tokens: torch.Tensor,
                logit_pos: Optional[int] = None):
        """tokens: (B, S) int64 -> (logits (B, V) fp32 at ``logit_pos``
        (default: last), (k, v) each (L, B, S, Hkv, hd) in the param dtype).

        ``logit_pos`` supports length-bucketed prefill: causal attention
        makes tail padding inert for positions <= logit_pos."""
        a = self.arch
        x = params["embed"][tokens]
        if a.tie_embeddings:
            x = x * math.sqrt(a.d_model)
        x = x.to(self.dtype)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        if a.pos_emb == PosEmb.SINUSOIDAL:
            x = x + sinusoidal_pos(positions, a.d_model).to(x.dtype)
        seg = params["seg0"]
        ks, vs = [], []
        for i in range(a.n_layers):
            p = {k: t[i] for k, t in seg.items()}
            h = rms_norm(x, p["ln1"], a.norm_eps)
            res, (k, v) = self_attention_full(h, p, a, positions=positions,
                                              return_kv=True)
            ks.append(k)
            vs.append(v)
            x = x + res
            h = rms_norm(x, p["ln2"], a.norm_eps)
            x = x + gated_mlp(h, p["wg"], p["wu"], p["wd"], a.act)
        x = rms_norm(x, params["final_ln"], a.norm_eps)
        pos = s - 1 if logit_pos is None else logit_pos
        logits = x[:, pos].float() @ self.head_weight(params).float()
        return logits, (torch.stack(ks), torch.stack(vs))
