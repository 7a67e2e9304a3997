"""Plain PyTorch reference of a dense GQA decoder (the Granite and Phi-3
families as their configuration files state them), with no kernel, cache
or batching, and nothing of the port imported.

It reads the weights the harness made (bf16, the layout the port takes:
``embed`` (V, d), ``final_ln`` (d,), ``seg0`` stacked (L, ...) leaves
``ln1 ln2 wq wk wv wo wg wu wd``) and recomputes everything else, the
fp32 copy of the weights included, layer by layer, so that it fits beside
them. The configuration's scalars are honoured as written:
``embedding_multiplier`` (default 1), ``attention_multiplier`` (default
1/sqrt(head_dim)), ``residual_multiplier`` (1), ``logits_scaling`` (1),
``partial_rotary_factor`` (1; rotary dims split in halves, as the port's
RoPE and Granite's), ``rope_theta``, ``rms_norm_eps``.

Every matrix product takes a precision: ``fp32`` (TF32 off: the
reference), ``tf32`` (operands rounded to TF32's 10-bit mantissa, fp32
sums) or ``fp8`` (operands scaled to e4m3 per row of the left and per
column of the right operand, fp32 sums). The two lower ones are the
control: the reference computed one step below the precision the
configuration states. A sequence's rows before ``boundary`` (its prompt)
take the first of its two precisions, the rest the second.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest (ties away) at TF32's 10 mantissa bits."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """e4m3 with one scale for each slice along ``dim`` (the summed dim)."""
    x = x.float()
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return a @ b
    if prec == "tf32":
        return round_tf32(a) @ round_tf32(b)
    if prec == "fp8":
        return round_fp8(a, -1) @ round_fp8(b, -2)
    raise ValueError(f"unknown precision {prec!r}")


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32 on the card (TF32 off), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta, rot):
    """x (T, H, D): the first ``rot`` dims rotated, split in halves."""
    t = x.shape[0]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., rot:]], dim=-1)


class _Rows:
    """A sequence's rows split at its prompt boundary, each part with its
    precision; ``lin`` applies one product to both parts."""

    def __init__(self, boundary: int, precs: Tuple[str, str]):
        self.b, self.precs = boundary, precs

    def parts(self, t: int):
        out = []
        if self.b > 0:
            out.append((0, min(self.b, t), self.precs[0]))
        if self.b < t:
            out.append((self.b, t, self.precs[1]))
        return out

    def lin(self, x, w):
        return torch.cat([mm(x[a:b], w, p) for a, b, p in
                          self.parts(x.shape[0])], dim=0)


def _attention(q, k, v, rows: _Rows, scale):
    """q (T, Hq, D), k and v (T, Hkv, D) -> (T, Hq * D), causal."""
    t, hq, hd = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)    # (Hq, T, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    outs = []
    for a, b, p in rows.parts(t):
        s = mm(q[a:b].transpose(0, 1), k.transpose(1, 2), p) * scale
        pos = torch.arange(a, b, device=q.device)[:, None]
        keys = torch.arange(t, device=q.device)[None]
        s = s.masked_fill(keys > pos, float("-inf"))
        o = mm(torch.softmax(s, dim=-1), v, p)            # (Hq, n, D)
        outs.append(o.transpose(0, 1).reshape(b - a, hq * hd))
    return torch.cat(outs, dim=0)


def logits(weights: Dict, cfg: Dict, seqs: Sequence[Dict]
           ) -> List[torch.Tensor]:
    """Logits (fp32) at rows ``first`` .. T-1 of each sequence.

    ``seqs``: [{tokens: (T,) int64 on the weights' device, first: int,
    boundary: int, precs: (prompt's, the rest's)}]."""
    if cfg.get("hidden_act", "silu") != "silu" or cfg.get("attention_bias"):
        raise NotImplementedError("dense_gqa: SwiGLU without biases only")
    L = cfg["num_hidden_layers"]
    d, hq, hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                  cfg["num_key_value_heads"])
    hd = cfg.get("head_dim") or d // hq
    eps = cfg["rms_norm_eps"]
    theta = cfg["rope_theta"]
    rot = int(hd * cfg.get("partial_rotary_factor", 1.0)) // 2 * 2
    em = cfg.get("embedding_multiplier", 1.0)
    am = cfg.get("attention_multiplier", 1.0 / math.sqrt(hd))
    rm = cfg.get("residual_multiplier", 1.0)
    ls = cfg.get("logits_scaling", 1.0)
    seg = weights["seg0"]
    rows = [_Rows(s["boundary"], tuple(s["precs"])) for s in seqs]
    with exact_fp32(), torch.no_grad():
        emb = weights["embed"]
        xs = [emb[s["tokens"]].float() * em for s in seqs]
        for i in range(L):
            w = {k: t[i].float() for k, t in seg.items()}
            for j, (x, r) in enumerate(zip(xs, rows)):
                t = x.shape[0]
                h = _rms(x, w["ln1"], eps)
                q = r.lin(h, w["wq"]).reshape(t, hq, hd)
                k = r.lin(h, w["wk"]).reshape(t, hkv, hd)
                v = r.lin(h, w["wv"]).reshape(t, hkv, hd)
                q, k = _rope(q, theta, rot), _rope(k, theta, rot)
                x = x + rm * r.lin(_attention(q, k, v, r, am), w["wo"])
                h = _rms(x, w["ln2"], eps)
                gate = r.lin(h, w["wg"])
                x = x + rm * r.lin(gate * torch.sigmoid(gate)
                                   * r.lin(h, w["wu"]), w["wd"])
                xs[j] = x
            del w
        head = emb.float().T
        out = []
        for s, x, r in zip(seqs, xs, rows):
            h = _rms(x, weights["final_ln"].float(), eps)
            first = s["first"]
            sub = _Rows(max(r.b - first, 0), r.precs)
            out.append(sub.lin(h[first:], head) / ls)
        return out
