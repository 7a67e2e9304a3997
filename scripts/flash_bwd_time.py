#!/usr/bin/env python3
"""Kernel B2's backward (flash attention's gradient) on one CUDA card, for
one source tree of the PyTorch/CUDA port, beside SDPA's backward.

  python3 scripts/flash_bwd_time.py [--src DIR] [--tag NAME]

``--src`` is a directory holding ``repro_torch`` (default: this checkout's
``src``), so two versions can be timed in one command on one card: unpack
the other commit with ``git archive`` into a directory that ``.gitignore``
lists and run this script on each tree in turns (A, B, B, A). A design
variant of the kernel is timed the same way, from a copy of the tree with
that variant's source.

At the training paths' shapes (bf16, B=2, 4096-token causal sequences:
granite-3-8b's 32/8 heads of 128 and zamba2-7b's 32/32 heads of 112), the
gradients through ``flash_attention``'s autograd Function (whatever
backward that tree runs on the card) are first held against autograd of
``flash_attention_ref`` (2e-2). Then, each with CUDA events around 20
calls, three times: that Function's backward of one retained forward
(``backward_ms``); the backward kernel itself, ``flash_attention_backward``
from the forward's logsumexp (``kernel_ms``), with each of its passes'
device ms from torch.profiler (``passes``); and SDPA's backward of one
retained forward on the same tensors (``sdpa_backward_ms``), with the
device kernels it runs by name (``sdpa_kernels``). Beside them, the
forward kernel (``flash_attention``, no grad) and SDPA's forward, as
device ms from torch.profiler (``forward_device_ms``,
``sdpa_forward_device_ms``). Prints the card (``nvidia-smi`` name and
power limit) and one JSON line per shape; exits non-zero without a card
or when a gradient disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 4096, 32, 8, 128), (2, 4096, 32, 32, 112))
TOL = dict(rtol=2e-2, atol=2e-2)


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


def kernels_ms(torch, fn, n: int = 5) -> dict:
    """Device ms a call of every kernel ``fn`` runs, by name, from
    torch.profiler over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:120]: e.self_device_time_total / n / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def max_err(torch, got, want) -> tuple:
    """Largest abs error over the gradients, and whether every one is
    finite and within TOL of its counterpart."""
    ok, err = True, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        ok = ok and bool(torch.isfinite(g).all()) \
            and bool(torch.allclose(g, w, **TOL))
        err = max(err, float((g - w).abs().max()))
    return err, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_bwd_time.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_ref, ops)

    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, check=True
    ).stdout.strip()
    print(f"card: {card}; tree: {args.tag} ({args.src})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for b, s, hq, hkv, d in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, dout = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*xs, causal=True)
        grads = torch.autograd.grad(out, xs, dout, retain_graph=True)
        ref = flash_attention_ref(*xs, causal=True)
        want = torch.autograd.grad(ref, xs, dout)
        del ref
        err, ok = max_err(torch, grads, want)
        bad += not ok
        del want
        shape = f"B={b} S={s} H={hq}/{hkv} D={d} causal bf16"

        def backward():
            return torch.autograd.grad(out, xs, dout, retain_graph=True)
        lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
        o = ops._launch(q, k, v, True, 0, None, None, lse)

        def kernel():
            return flash_attention_backward(q, k, v, o, dout, lse,
                                            causal=True)
        qt, kt, vt, dt = (t.transpose(1, 2) for t in (q, k, v, dout))

        def forward():
            with torch.no_grad():
                return flash_attention(q, k, v, causal=True)

        def sdpa_forward():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        sdpa = cs._retained_bwd(
            torch, lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=True, enable_gqa=True), (qt, kt, vt), dt)
        print(json.dumps({
            "tree": args.tag, "shape": shape, "max_abs_err": err,
            "within_tol": ok, "backward_ms": events_ms(torch, backward),
            "kernel_ms": events_ms(torch, kernel),
            "passes": cs.pass_ms(torch, kernel,
                                 cs.PORT_KERNELS["flash_attention_bwd"]),
            "sdpa_backward_ms": events_ms(torch, sdpa),
            "sdpa_kernels": kernels_ms(torch, sdpa),
            "forward_device_ms": cs.device_ms(
                torch, forward, n=10, stem=cs.PORT_KERNELS["flash_attention"]),
            "sdpa_forward_device_ms": cs.device_ms(torch, sdpa_forward,
                                                   n=10)}), flush=True)
        del out, xs, q, k, v, dout, grads, o, lse, qt, kt, vt, dt, sdpa
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
