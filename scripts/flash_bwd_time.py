#!/usr/bin/env python3
"""Kernel B2's backward (flash attention's gradient) on one CUDA card, for
one source tree of the PyTorch/CUDA port.

  python3 scripts/flash_bwd_time.py [--src DIR] [--tag NAME]

``--src`` is a directory holding ``repro_torch`` (default: this checkout's
``src``), so two versions can be timed in one command on one card: unpack
the other commit with ``git archive`` into a directory that ``.gitignore``
lists and run this script on each tree in turns (A, B, B, A). The backward
is reached through ``flash_attention``'s autograd Function, the entry
point every version has: whatever backward that tree runs on the card
(the closed form in PyTorch ops before the backward kernel, the kernel
after) is what is timed.

At the training paths' shapes (bf16, B=2, 4096-token causal sequences:
granite-3-8b's 32/8 heads of 128 and zamba2-7b's 32/32 heads of 112), the
gradients are first held against autograd of ``flash_attention_ref``
(2e-2), then the backward of one retained forward is timed with CUDA
events around 20 calls, three times. Prints the card (``nvidia-smi`` name
and power limit) and one JSON line per shape; exits non-zero without a
card or when a gradient disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 4096, 32, 8, 128), (2, 4096, 32, 32, 112))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_time.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, check=True
    ).stdout.strip()
    print(f"card: {card}; tree: {args.tag} ({args.src})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, hq, hkv, d in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, dout = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        xs = [t.requires_grad_() for t in (q, k, v)]
        out = flash_attention(*xs, causal=True)
        grads = torch.autograd.grad(out, xs, dout, retain_graph=True)
        ref = flash_attention_ref(*xs, causal=True)
        want = torch.autograd.grad(ref, xs, dout)
        del ref
        err = max(cs.check_close(torch, g, w, "bf16", f"d{n}")
                  for n, g, w in zip("qkv", grads, want))
        del grads, want

        def backward():
            return torch.autograd.grad(out, xs, dout, retain_graph=True)
        for _ in range(3):
            backward()
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                backward()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / 20)
        print(json.dumps({"tree": args.tag, "shape": f"B={b} S={s} "
                          f"H={hq}/{hkv} D={d} causal bf16",
                          "max_abs_err": err, "backward_ms": ms}),
              flush=True)
        del out, xs, q, k, v, dout
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
