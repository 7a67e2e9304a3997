#!/usr/bin/env python3
"""Kernel B2's fp32 route (flash attention in fp32, the engine's chunked
prefill) on one CUDA card, for one source tree of the PyTorch/CUDA port,
beside SDPA on the same inputs.

  python3 scripts/flash_f32_time.py [--src DIR] [--tag NAME] [--reps N]

``--src`` is a directory holding ``repro_torch`` (default: this checkout's
``src``), so two versions (or a design variant in a copy of the tree) can
be timed in one command on one card: run this script on each tree in turns
(A, B, B, A).

At the shapes llama2-7b's chunked prefill launches with
``prefill_chunk=256`` (B=1, 32/32 heads of 128, causal, kv_len = Skv; the
full chunks and the tails the engine pads to a power-of-two bucket), each
output is first held against ``flash_attention_ref`` (rtol = atol = 2e-5).
Then, ``--reps`` times each: the kernel's device ms a call
(``chip_smoke.device_ms``: torch.profiler, or CUDA events behind a spin
where the profiler drops a launch) and its host-loop ms (CUDA events around
a loop of calls), and SDPA's device ms with the boolean mask built outside
the timed call, with the device kernels SDPA runs by name. Beside them the
bound two ways: the bytes (q, k, v read once, o written once) over 3.35
TB/s against the products as fp32 FMAs at 67 TFLOP/s
(``bound_fp32_ms``), and against them as three tf32 products at the dense
tf32 peak, 495 TFLOP/s (``bound_tf32x3_ms``). A fresh build's ptxas lines
of the fp32 kernel (registers, spills) are printed first. Prints the card
(``nvidia-smi`` name and power limit) and one JSON line per shape; exits
non-zero without a card or when an output disagrees with the plain
version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (Sq, Skv, q_offset) of the chunked path, the two the issue times first
SHAPES = ((256, 768, 512), (256, 1024, 768), (256, 256, 0), (256, 512, 256),
          (64, 576, 512), (128, 896, 768), (64, 832, 768))
HEADS, HEAD_DIM = 32, 128
TOL = dict(rtol=2e-5, atol=2e-5)
TF32_PEAK = 495e12                 # H100 SXM dense tf32, datasheet


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_f32_time.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, check=True
    ).stdout.strip()
    print(f"card: {card}; tree: {args.tag} ({args.src})", flush=True)
    _build.module()
    log = _build.ptxas_log().splitlines()
    for i, line in enumerate(log):
        if "flash_fwd_f32" in line and "Function properties" in line:
            print("[ptxas] " + " | ".join(x.strip() for x in log[i:i + 3]),
                  flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for sq, skv, off in SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        q = randn(1, sq, HEADS, HEAD_DIM)
        k, v = randn(1, skv, HEADS, HEAD_DIM), randn(1, skv, HEADS, HEAD_DIM)
        kl = torch.full((1,), skv, dtype=torch.int32, device="cuda")

        def kern():
            return flash_attention(q, k, v, causal=True, q_offset=off,
                                   kv_len=kl)
        got = kern()
        want = flash_attention_ref(q, k, v, causal=True, q_offset=off,
                                   kv_len=kl)
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and bool(
            torch.allclose(got, want, **TOL))
        bad += not ok
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qpos = torch.arange(sq, device="cuda")[:, None] + off
        mask = torch.arange(skv, device="cuda")[None, :] <= qpos

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        pairs = float(torch.clamp(torch.arange(sq, dtype=torch.float64)
                                  + off + 1, max=skv).sum())
        flops = 4.0 * pairs * HEADS * HEAD_DIM
        nbytes = (2 * sq + 2 * skv) * HEADS * HEAD_DIM * 4
        stem = cs.PORT_KERNELS["flash_attention"]
        print(json.dumps({
            "tree": args.tag, "shape": f"B=1 Sq={sq} Skv={skv} q_offset={off}"
            f" H={HEADS}/{HEADS} D={HEAD_DIM} fp32", "max_abs_err": err,
            "within_tol": ok,
            "device_ms": [cs.device_ms(torch, kern, stem=stem)
                          for _ in range(args.reps)],
            "host_loop_ms": [timer(kern) for _ in range(args.reps)],
            "sdpa_device_ms": [cs.device_ms(torch, sdpa)
                               for _ in range(args.reps)],
            "sdpa_kernels": cs._device_ms_by_kernel(torch, sdpa, n=5)[0],
            "bound_fp32_ms": cs.bound(nbytes, {"fp32": flops})[0],
            "bound_tf32x3_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                                   3 * flops / TF32_PEAK) * 1e3,
            "bytes_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
