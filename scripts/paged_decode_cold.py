#!/usr/bin/env python3
"""Kernel B1 (paged decode attention) timed cold at chip_smoke.py's B1
shapes, for one source tree of the PyTorch/CUDA port, on one CUDA card.

  python3 scripts/paged_decode_cold.py [--src DIR] [--tag NAME]

``--src`` is a directory holding ``repro_torch`` (default: this checkout's
``src``), so two versions of the kernel can be timed in one command on one
card: unpack the other commit with ``git archive`` into a directory that
``.gitignore`` lists and run this script on each tree in turns (A, B, B,
A). The kernel is reached only through ``paged_decode_attention``, the
entry point every version has, and built from that tree's sources.

For each case (the four shapes of chip_smoke.py's B1 phase, then the main
path's ragged batch: lengths 960, 544, 160 and five idle slots of length 1
on the null page), with inputs from a seeded generator of its own: the
kernel is held against ``paged_decode_ref`` (2e-5 fp32, 2e-2 bf16), then
timed with every call on the next of several clones of the pools, enough
that a cycle reads more than twice the 50 MB L2 (``chip_smoke.cold_sets``),
as the engine's layers each read their own pool. Device time per call is
``chip_smoke.queued_ms`` (CUDA events around calls queued behind a spin,
so the gap between a version's kernels counts), with each kernel's
profiler mean beside it. Prints the card (``nvidia-smi`` name and power
limit) and one JSON line per case; exits non-zero without a card or when
a case disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("paged_decode_cold.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention,
        paged_decode_ref,
    )

    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, check=True
    ).stdout.strip()
    print(f"[card] {card}; {args.tag}: {args.src}", flush=True)
    stem = cs.PORT_KERNELS["paged_decode_attention"]
    _build.build()
    ptxas = cs.ptxas_report(_build.ptxas_log(), stem)
    print("[build] ptxas: " + json.dumps(ptxas), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b, hq, hkv, kind, None) for b, hq, hkv, kind in cs.B1_CASES]
    cases.append((8, 32, 32, "fp32", cs.MAIN_PATH_LENGTHS))
    for b, hq, hkv, kind, lengths in cases:
        q, kp, vp, bt, ln = cs.paged_inputs(
            torch, gen, b, hq, hkv, kind, lengths
        )

        def attend(k, v):
            return paged_decode_attention(q, k, v, bt, ln)

        err = cs.check_close(
            torch,
            attend(kp, vp),
            paged_decode_ref(q, kp, vp, bt, ln),
            kind,
            f"{args.tag} B={b} {hq}/{hkv} {kind}",
        )
        read = 2 * float(ln.sum()) * hkv * kp.shape[3] * q.element_size()
        pools = cs.cold_sets((kp, vp), read)
        kern = cs.cycling(attend, pools)
        bound_ms, bound_by = cs.bound(*cs.paged_work(q, kp, bt, ln, kind))
        row = {
            "tag": args.tag,
            "case": f"B={b} H={hq}/{hkv} {kind}",
            "lengths": ln.tolist(),
            "max_abs_err": err,
            "cold_pool_sets": len(pools),
            "queued_ms": cs.queued_ms(torch, kern, n=50),
            "kernels_ms": cs.pass_ms(torch, kern, stem, n=20),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "card": card,
        }
        print(json.dumps(row), flush=True)
        del pools, kern, q, kp, vp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
