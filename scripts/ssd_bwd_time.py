#!/usr/bin/env python3
"""Kernel B4's backward (the SSD scan's gradient) on one CUDA card, for one
source tree of the PyTorch/CUDA port.

  python3 scripts/ssd_bwd_time.py [--src DIR] [--tag NAME] [--levers]

``--src`` is a directory holding ``repro_torch`` (default: this checkout's
``src``), so two versions can be timed in one command on one card: unpack
the other commit with ``git archive`` into a directory that ``.gitignore``
lists and run this script on each tree in turns (A, B, B, A). The backward
is reached through ``ssd_scan``'s autograd Function, the entry point every
version has.

At the training paths' shapes (bf16, 2 x 4096 tokens from a zero state,
chunks of 256: mamba2-1.3b's 64 heads of 64 with a state of 128, zamba2-7b's
112 heads with a state of 64), the gradients are first held against the
closed form ``ssd_scan_bwd`` (2e-2 of each gradient's largest), then the
backward of one retained forward is timed with CUDA events around 20 calls,
three times, and each pass's device time read by torch.profiler.
``--levers`` (a tree whose wrapper picks the heads a CTA of the backward's
passes 3 and 4 takes with ``_heads_per_cta``) also times the kernel itself
with 1, 2 and 4 heads a CTA. Prints the card (``nvidia-smi`` name and
power limit) and one JSON line per shape and reading; exits non-zero
without a card or when a gradient disagrees with the closed form.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, H, P, G, N, Q)
SHAPES = ((2, 4096, 64, 64, 1, 128, 256), (2, 4096, 112, 64, 1, 64, 256))


def events_ms(torch, fn, calls: int = 20, reps: int = 3) -> list:
    """Mean ms a call from CUDA events around ``calls`` calls, ``reps``
    times, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--levers", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_time.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, check=True
    ).stdout.strip()
    print(f"card: {card}; tree: {args.tag} ({args.src})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    names = ("dx", "ddt", "dA", "dBm", "dCm", "dD")
    bad = 0
    for b, s, h, p, g, n, q in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        bf = torch.bfloat16
        x, dy = randn(b, s, h, p).to(bf), randn(b, s, h, p).to(bf)
        bm, cm = randn(b, s, g, n).to(bf), randn(b, s, g, n).to(bf)
        dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.099 \
            + 0.001
        a = -(torch.rand((h,), generator=gen, device="cuda") * 1.5 + 0.5)
        d = randn(h)
        ins = [x, dt, a, bm, cm, d]
        xs = [t.detach().requires_grad_() for t in ins]
        y, _ = ssd_scan(*xs, chunk=q)
        got = torch.autograd.grad(y, xs, dy, retain_graph=True)
        want = ssd_scan_bwd(*ins, None, dy, None, chunk=q)
        rel = {}
        for name, gk, gw in zip(names, got, want):
            scale = float(gw.float().abs().max())
            rel[name] = float((gk.float() - gw.float()).abs().max()) / scale
        if max(rel.values()) > 2e-2:
            bad += 1
        del got, want
        shape = f"B={b} S={s} H={h} P={p} G={g} N={n} Q={q} bf16"

        def backward():
            return torch.autograd.grad(y, xs, dy, retain_graph=True)
        print(json.dumps({"tree": args.tag, "shape": shape,
                          "of_largest": rel,
                          "backward_ms": events_ms(torch, backward),
                          "passes": cs.pass_ms(torch, backward,
                                               "ssd_bwd_kernel")}),
              flush=True)
        if args.levers:
            from repro_torch.kernels.ssd_scan import ops
            chunk = ops._check(*ins, None, q)
            _, _, entry, cum = ops._launch(*ins, None, chunk)
            chosen = ops._heads_per_cta
            for hs in (1, 2, 4):
                if (h // g) % hs:
                    continue
                ops._heads_per_cta = lambda *a, hs=hs: hs

                def kernel():
                    return ops.ssd_scan_backward(*ins, dy, None, entry, cum,
                                                 chunk=chunk)
                print(json.dumps({
                    "tree": args.tag, "shape": shape, "heads_per_cta": hs,
                    "kernel_ms": events_ms(torch, kernel),
                    "passes": cs.pass_ms(torch, kernel, "ssd_bwd_kernel")}),
                    flush=True)
            ops._heads_per_cta = chosen
            del entry, cum
        del y, xs, ins, x, dy, bm, cm
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
