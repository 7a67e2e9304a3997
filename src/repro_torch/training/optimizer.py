"""AdamW with fp32 master state over bf16 params, global-norm clipping, a
cosine schedule, and int8 gradient compression with error feedback: the
port of ``repro.training.optimizer``, in PyTorch ops on the params'
device.

Trees are nested dicts of tensors (the ``LM`` parameter layout), walked
in sorted key order as JAX flattens them. Every function is functional,
as the reference's are: it returns new tensors and updates none of its
inputs in place."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # fp32 first moment
    nu: Any              # fp32 second moment
    master: Any          # fp32 master params
    ef: Optional[Any] = None   # error-feedback residual (compression)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of ``rest``, shaped
    alike), in sorted key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts in sorted key order (``tree_map``'s)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (int or int tensor), fp32: linear warmup,
    then a cosine decay to ``min_lr_frac`` of ``lr``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params, compression: bool = False) -> OptState:
    """Zero moments, an fp32 copy of the params as master weights, a zero
    error-feedback residual with ``compression``; the step on the params'
    device."""
    def f32(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(f32, params), nu=tree_map(f32, params),
        master=tree_map(lambda t: t.detach().to(torch.float32, copy=True),
                        params),
        ef=tree_map(f32, params) if compression else None)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for t in tree_leaves(tree):
        total = total + t.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def apply_adamw(cfg: AdamWConfig, grads, state: OptState, params
                ) -> Tuple[Any, OptState, dict]:
    """One AdamW step -> (new params in their own types, new state,
    {"grad_norm", "lr"}). Weight decay applies to every leaf of two or
    more dims, the reference's rule (so stacked norm weights (L, D) decay
    too)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(g, mu, nu, m):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        mh = mu / b1c
        nh = nu / b2c
        decay = cfg.weight_decay if m.dim() >= 2 else 0.0
        m = m - lr * (mh / (torch.sqrt(nh) + cfg.eps) + decay * m)
        return m, mu, nu

    outs = tree_map(upd, grads, state.mu, state.nu, state.master)
    new_master, new_mu, new_nu = (_pick(outs, i) for i in range(3))
    new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
    new_state = OptState(step=step, mu=new_mu, nu=new_nu, master=new_master,
                         ef=state.ef)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i: int):
    """Item ``i`` of every tuple leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (cross-pod all-reduce trick)
# ---------------------------------------------------------------------------
def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization -> (q, scale). ``round`` is
    half to even, as ``jnp.round``."""
    g32 = g.float()
    scale = g32.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compressed_grads_with_ef(grads, ef):
    """Quantize (g + residual) per leaf -> (dequantized grads, new
    residual). In production the int8 payload is what crosses the
    pod-level all-reduce; here compression and decompression bracket it."""
    def one(g, e):
        tot = g.float() + e
        q, s = compress_int8(tot)
        deq = decompress_int8(q, s)
        return deq, tot - deq

    outs = tree_map(one, grads, ef)
    return _pick(outs, 0), _pick(outs, 1)
