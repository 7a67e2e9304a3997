"""Training launcher of the port (``repro.launch.train``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --steps 50 [--microbatches 2] [--compression] [--ckpt DIR] \\
      [--device cpu]

``--smoke`` trains a reduced copy of the arch (batch 8, sequences of 64)
on the CUDA card, or with ``--device cpu`` on the CPU (the kernels' plain
versions). The reduced copy has d_model 256, so its attention heads are
64 wide, which kernel B2 takes; the reference's smoke model (d_model 64)
has heads of 16. A Mamba-2 or hybrid arch trains on the CPU only: kernel
B4 has no backward yet. Without ``--smoke`` it trains the arch at full
size, as the reference does, on the production mesh
(``make_production_mesh``, 16x16 or with ``--multi-pod`` 2x16x16) under
``make_policy(arch, TRAIN_4K, mesh)``, over the world that ``torchrun``
started (its environment initialises the process group); on a world of
fewer ranks the mesh raises ``RuntimeError``. With ``--ckpt`` it resumes
from the latest checkpoint there, each leaf laid out by its spec, and
saves one every 50 steps.

  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch granite-3-8b --steps 50
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import TRAIN_4K, get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NO_POLICY, make_policy
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LM
from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                  batch_at_step, init_train_state,
                                  latest_step, load, make_train_step, save)
from repro_torch.training.optimizer import OptState


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns {"arch", "device", "start", "steps", "losses"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.smoke:
        arch = reduced(get_arch(args.arch), d_model=256)
        policy = NO_POLICY
        batch, seq = 8, 64
    else:
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
        arch = get_arch(args.arch)
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
        policy = make_policy(arch, TRAIN_4K, mesh)
        batch, seq = TRAIN_4K.global_batch, TRAIN_4K.seq_len
    model = LM(arch, policy, device=device, loss_chunk=min(512, seq))
    tcfg = TrainConfig(adamw=AdamWConfig(total_steps=args.steps),
                       microbatches=args.microbatches,
                       grad_compression=args.compression)
    dcfg = DataConfig(vocab=arch.vocab, seq_len=seq, global_batch=batch,
                      family=arch.family.value, d_model=arch.d_model,
                      n_frontend_tokens=arch.n_frontend_tokens)
    step_fn = make_train_step(model, tcfg)

    start = latest_step(args.ckpt) if args.ckpt else None
    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   tcfg)
    if start:
        pspecs = model.param_specs()
        shardings = {"params": pspecs, "opt": OptState(
            step=None, mu=pspecs, nu=pspecs, master=pspecs,
            ef=pspecs if opt.ef is not None else None)}
        restored, _ = load(args.ckpt, start, {"params": params, "opt": opt},
                           shardings=shardings if policy.mesh else None,
                           mesh=policy.mesh)
        params, opt = restored["params"], restored["opt"]
        print(f"[train] resumed at step {start}")
    start = start or 0
    losses = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        params, opt, m = step_fn(params, opt,
                                 batch_at_step(dcfg, i, device=device))
        losses.append(m["loss"])
        if (i + 1) % 10 == 0:
            print(f"[train] step {i+1} loss={float(m['loss']):.4f} "
                  f"({(time.perf_counter()-t0)/(i+1-start):.2f}s/step)")
        if args.ckpt and (i + 1) % 50 == 0:
            save(args.ckpt, i + 1, {"params": params, "opt": opt})
    print(f"[train] done on {device}")
    return {"arch": arch.name, "device": str(device), "start": start,
            "steps": args.steps, "losses": [float(v) for v in losses]}


if __name__ == "__main__":
    main()
