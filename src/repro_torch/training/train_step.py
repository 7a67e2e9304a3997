"""Training step, the port of ``repro.training.train_step``: loss and
gradients with microbatch accumulation (fp32 sums), bf16 params with fp32
AdamW master state, and optional int8 gradient compression bracketing the
cross-pod all-reduce.

The step is functional, as the reference's is: it returns new params and
a new ``OptState`` and updates neither input in place, so a caller may
step twice from the same state. Its phases run inside
``torch.profiler.record_function`` ranges named ``train_step.forward``,
``train_step.backward`` and ``train_step.optimizer``, so a profile of a
step splits its device time by phase (a range costs nothing without a
profiler). Under a mesh, params, state and batch are DTensors (the
``LM``'s policy lays them out) and each gradient is laid out as its
parameter before the optimizer reads it."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.models.model import LM
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            apply_adamw,
                                            compressed_grads_with_ef,
                                            init_opt_state, tree_leaves,
                                            tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1           # grad-accumulation steps per train step
    grad_compression: bool = False  # int8 + error feedback


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """(B, ...) -> n batches of (B/n, ...), rows in order."""
    def sp(t):
        b = t.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows is not {n} microbatches")
        return t.split(b // n)
    parts = {k: sp(t) for k, t in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _laid_out_like(g, t):
    """A DTensor gradient laid out as its parameter (a pending sum over
    the shards that shared the parameter reduced); else ``g``."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _value_and_grad(model: LM, params, batch):
    """(loss, grads in the params' types, metrics) of one batch. A leaf
    the loss does not read (an audio model's embedding table) gets a zero
    gradient, as JAX gives it."""
    with record_function("train_step.forward"):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.train_loss(p, batch)
    with record_function("train_step.backward"), model.replicating():
        flat = tree_leaves(p)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else _laid_out_like(g, t)
              for t, g in zip(flat, gs))
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), grads, {k: v.detach() for k, v in metrics.items()}


def loss_and_grads(model: LM, params, batch, microbatches: int = 1):
    """Mean loss, grads and the last microbatch's metrics. Over several
    microbatches the gradients are summed in fp32 and divided by their
    count (so they come back fp32); with one, they come back in the
    params' types, as JAX's."""
    if microbatches <= 1:
        return _value_and_grad(model, params, batch)
    acc, loss_sum = None, 0.0
    for mb in _split_microbatches(batch, microbatches):
        loss, g, metrics = _value_and_grad(model, params, mb)
        with torch.no_grad():
            if acc is None:
                acc = tree_map(lambda t: t.to(torch.float32, copy=True), g)
            else:
                tree_map(lambda a, t: a.add_(t), acc, g)
        loss_sum = loss_sum + loss
        del g
    grads = tree_map(lambda t: t / microbatches, acc)
    return loss_sum / microbatches, grads, metrics


def make_train_step(model: LM, cfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics {"xent", "lb_loss", "moe_drops", "grad_norm", "lr",
    "loss"}), pure: neither input is updated in place."""

    def train_step(params, opt_state: OptState, batch):
        loss, grads, metrics = loss_and_grads(model, params, batch,
                                              cfg.microbatches)
        with record_function("train_step.optimizer"):
            if cfg.grad_compression and opt_state.ef is not None:
                grads, new_ef = compressed_grads_with_ef(grads, opt_state.ef)
                opt_state = opt_state._replace(ef=new_ef)
            new_params, new_opt, od = apply_adamw(cfg.adamw, grads,
                                                  opt_state, params)
        metrics = dict(metrics)
        metrics.update(od)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def init_train_state(model: LM, generator: torch.Generator,
                     cfg: TrainConfig):
    """(params from ``model.init(generator)``, a fresh ``OptState``)."""
    params = model.init(generator)
    opt = init_opt_state(params, compression=cfg.grad_compression)
    return params, opt


__all__ = ["TrainConfig", "loss_and_grads", "make_train_step",
           "init_train_state"]
