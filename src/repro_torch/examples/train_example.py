"""Train a small dense LM with the port's whole training substrate: AdamW
with the cosine schedule, microbatch accumulation, int8 gradient
compression with error feedback, periodic checkpoints, and a restart that
resumes from the latest one. The port's twin of the reference's
``examples/train_example.py``, with its counts and seeds (200 steps, 2
microbatches of 4 x 64 tokens, a checkpoint every 100 steps).

  PYTHONPATH=src python -m repro_torch.examples.train_example \\
      [--steps 200] [--ckpt DIR] [--device cpu]

Runs on the CUDA card, or with ``--device cpu`` on the CPU (the kernels'
plain versions). The reference's model, reduced granite-3-8b (4 layers,
d_model 128, 8 query heads over 4 K/V heads, d_ff 512, vocab 512), has
heads of 16, which kernel B2 does not take (64 or 128); this one keeps
every one of those numbers and sets the head dim to 64, so q, k and v
project to 512, 256 and 256. The checkpoints go under the temporary
directory unless ``ckpt`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import DeviceLike
from repro_torch.models.model import LM
from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                  batch_at_step, init_train_state,
                                  latest_step, load, make_train_step, save)
from repro_torch.training.optimizer import tree_leaves


def main(device: DeviceLike = None, steps: int = 200,
         ckpt: Optional[str] = None, ckpt_every: int = 100) -> dict:
    """Train to ``steps``, resuming from the latest checkpoint in ``ckpt``
    when there is one, and saving one every ``ckpt_every`` steps. Returns
    a summary: where it started, the loss of every step it ran, and the
    parameter count."""
    ckpt = ckpt or os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_ckpt")
    arch = dataclasses.replace(
        reduced(get_arch("granite-3-8b"), n_layers=4, d_model=128,
                vocab=512, n_heads=8, n_kv_heads=4, d_ff=512), head_dim=64)
    model = LM(arch, device=device, loss_chunk=32)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=20,
                                         total_steps=steps),
                       microbatches=2, grad_compression=True)
    dcfg = DataConfig(vocab=arch.vocab, seq_len=64, global_batch=8)
    step_fn = make_train_step(model, tcfg)

    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   tcfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {arch.name} ({n_params / 1e6:.2f}M params) on "
          f"{model.device}")
    start = latest_step(ckpt) or 0
    if start:
        restored, _ = load(ckpt, start, {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"resumed from checkpoint at step {start}")

    losses = []
    t0 = time.perf_counter()
    for i in range(start, steps):
        params, opt, m = step_fn(params, opt,
                                 batch_at_step(dcfg, i, model.device))
        losses.append(m["loss"])
        if (i + 1) % 25 == 0:
            dt = time.perf_counter() - t0
            print(f"step {i+1:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"({dt/(i+1-start):.3f}s/step)")
        if (i + 1) % ckpt_every == 0:
            save(ckpt, i + 1, {"params": params, "opt": opt},
                 extra={"data_step": i + 1})
            print(f"  checkpointed step {i+1}")
    print("done.")
    return {"params": n_params, "start": start, "steps": steps,
            "losses": [float(v) for v in losses],
            "wall_s": time.perf_counter() - t0}


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    main(args.device, args.steps, args.ckpt)


if __name__ == "__main__":
    cli()
