#!/usr/bin/env python3
"""Kernel B3 (RMSNorm) wrapper's host time per call beside F.rms_norm's,
for one source tree of the PyTorch/CUDA port, on one CUDA card.

  python3 scripts/rmsnorm_host.py [--src DIR] [--tag NAME]

``--src`` is a directory holding ``repro_torch`` (default: this checkout's
``src``), so two versions of the wrapper can be timed in one command on
one card: unpack the other commit with ``git archive`` into a directory
that ``.gitignore`` lists and run this script on each tree in turns (A, B,
B, A). The kernel is built from that tree's sources and reached through
``rmsnorm``, the entry point every version has.

At chip_smoke.py's B3 shapes (1024 x 4096 and 8192 x 4096, bf16), after
checking the kernel against ``rmsnorm_ref`` (2e-2), each of the wrapper
and ``F.rms_norm`` is timed on the host with ``chip_smoke.host_us`` (the
least of 5 loops of 200 calls queued without a synchronise), in turns,
three times. Prints the card (``nvidia-smi`` name and power limit) and one
JSON line per shape; exits non-zero without a card or when the kernel
disagrees with the plain version.
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
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("rmsnorm_host.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    query = ["--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(
        ["nvidia-smi", *query], capture_output=True, text=True, check=True
    ).stdout.strip()
    print(f"card: {card}; tree: {args.tag} ({args.src})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in (1024, 8192):
        x = torch.randn((rows, 4096), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn((4096,), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        err = cs.check_close(torch, rmsnorm(x, w, eps=1e-5),
                             rmsnorm_ref(x, w, None, 1e-5), "bf16",
                             f"rmsnorm {rows}x4096")
        times = {"wrapper": [], "F.rms_norm": []}
        for _ in range(3):
            times["wrapper"].append(cs.host_us(
                torch, lambda: rmsnorm(x, w, eps=1e-5)))
            times["F.rms_norm"].append(cs.host_us(
                torch, lambda: F.rms_norm(x, (4096,), w, 1e-5)))
        print(json.dumps({"tree": args.tag, "at": f"{rows}x4096 bf16",
                          "max_abs_err": err, "host_us": times,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
