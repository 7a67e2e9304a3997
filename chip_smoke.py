#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py            # from the repository root, one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit) and turns TF32 off
   for fp32 matmuls and convolutions.
2. Builds the port's CUDA kernels from ``src/repro_torch/kernels/**/csrc``
   with nvcc for sm_90a, and prints the build time and ptxas's register and
   spill report, with a ``[build] B1 ptxas`` line of B1's instantiations;
   a spill in any of them raises.
3. Kernel phases: each kernel (B1 paged decode, B2 flash attention, B3
   RMSNorm) runs through its wrapper on the card at the shapes of the
   paths below (llama2-7b's, then mamba2-1.3b's and zamba2-7b's, then
   qwen2-moe-a2.7b's: B3 at 2048 x 2048 and 2 x 2048, B2 at B=2,
   1024/1024, 16/16 heads, D = 128; and last llama-3.2-vision-90b's: B3
   at 2048 x 8192 and 2 x 8192, B2 at B=2, 64/8 heads, D = 128, causal
   1024/1024 and non-causal 1024/1601 in bf16, and non-causal B=1,
   256/1601 in fp32, the route of an fp32 frontend), is held
   against its plain PyTorch version on the same inputs (allclose, rtol =
   atol = 2e-5 in fp32 and 2e-2 in bf16), and is timed with CUDA
   events beside its plain version, a PyTorch library call computing the
   same function where one exists (for B2, SDPA: causal, unmasked for a
   non-causal case, or with a boolean mask built outside the timed call
   for a q_offset and kv_len),
   and its bound; the kernel's and the library call's device time per call
   from torch.profiler, or from CUDA events around calls queued behind a
   spin kernel where the profiler misses the kernel (``device_ms``), beside
   the host-loop times, so a launch-bound case shows as one. The bound is
   the larger of the bytes it must move over 3.35 TB/s and its operations
   over the peak rate of their type (989 TFLOP/s bf16 tensor core, 67
   TFLOP/s fp32), the H100 SXM datasheet figures. B2 runs every prefill
   bucket (64-1024), GQA 32/8, D = 64, 112 (B=2) and 128, a ragged Sq
   and a q_offset/kv_len cut mid-tile in bf16 and fp32. B1 and B2 are
   also held against their plain versions on rows that see no key (the
   mean of V). B1 is timed cold:
   each call reads the next of enough clones of the pools that a cycle
   reads more than twice the 50 MB L2, as each layer of the engine reads
   its own pool; its device time comes from CUDA events around calls
   queued behind a spin (its two kernels overlap by design, see
   ``paged_case``) and a time under the bound raises. Its cases: batch 1,
   batch 8 (32/32 and GQA 32/8 in fp32, 32/32 in bf16), then, after every
   other case so the earlier seeded draws stay, the main path's ragged
   batch (lengths 960, 544, 160 and five idle slots of length 1 on the
   null page); a ``[paged_decode split]`` line per case gives the split
   plan, each kernel's profiler time and the wrapper's host time. B3's
   wrapper must refuse each of a list of bad CUDA inputs with its earlier
   error type, and a line per bf16 shape splits its host time per call
   (checks, stream, allocation, launch; each beside what it replaced)
   beside ``F.rms_norm``'s.
4. Small reference check: the port's engine on the card and on the CPU
   (plain versions) generate the same tokens for a reduced fp32 model,
   one-shot and chunked prefill.
5. Main path: a ``ServingCluster`` of 2 ``PagedEngine`` workers sharing one
   full-width ``llama2-7b`` (random bf16 weights from a seed; default pool
   of 512 pages x 16 tokens, fp32 KV, per worker) serves a Poisson trace of
   12 requests at 8/s (prompts 64-960 tokens, 16-32 output tokens) with
   ``policy="aladdin"`` (Algorithm 1 placement, Algorithm 2 re-balancing)
   and one engine iteration per worker per heartbeat, until drained. Launch
   counters are zeroed just before and read just after; every kernel must
   have run. The engines' TraceBuffers refit the Eq. 2/3 models on the
   card's iteration times. The cluster makes one fp32 copy of the weights
   for decode and hands it to both workers; the mean decode iteration is
   printed, and on a line of its own the constant 48.7 ms, the mean of an
   earlier run (run F) that promoted the weights on every step.
6. Breakdown: one more engine on the same weights (and the same fp32
   copy); prefill time at each bucket (cold, then warm) and a decode step
   at batch 8 x 512-token contexts, each on the host clock, with device
   time by kernel, the count of device operations and the time in
   ``direct_copy`` kernels from torch.profiler (a copy among the decode
   step's ten costliest device operations fails the run); the decode
   step's wall is printed, and on a line of its own run F's 49.8 ms. The llama2-7b weights
   and their fp32 copy are then freed.
7. B4 (Mamba-2 SSD scan) kernel phase at the mamba2-1.3b and zamba2-7b
   prefill shapes (ragged S in fp32 and bf16, a two-group case and batch
   1 in bf16 among them), held against its plain version (y at the
   tolerances above, the final state at 1e-3) and timed beside it, with a
   line of each pass's device time; its bound (``ssd_bound_work``) counts
   the operations as the three-pass kernel does them and the bytes of the
   scan's inputs and outputs, and a device time under it raises.
8. Generation reference check: reduced fp32 mamba2-1.3b and zamba2-7b
   generate (prefill, 12 greedy decode steps, flushes every 8) with the
   same tokens on the card and on the CPU.
9. SSM path: full-width mamba2-1.3b (random bf16 weights, seed 0) through
   ``LM.prefill`` / ``LM.decode_step``: 4 prompts of 2048 tokens and 64
   greedy steps, then 2 of 1000 and 16 steps. Hybrid path: full-width
   zamba2-7b, 2 prompts of 1024 and 48 steps with a recent window of 32.
   For each: prefill ms cold and warm, decode ms per step, tokens/s, peak
   memory and launches (counters zeroed just before, read just after; B4
   must run once per Mamba layer per prefill, for the hybrid B2 once per
   attention block per prefill, and B3 once per norm per prefill and per
   decode step: since PR 17 on every generation path), then device time
   by kernel and the count of device operations of one warm prefill and
   one decode step.
10. MoE generation reference check: reduced fp32 qwen2-moe-a2.7b and
   moonshot-v1-16b-a3b at batch 8, where the decode steps' expert
   capacity (its floor of 4) drops assignments, generate (prefill, 12
   greedy decode steps, flushes every 8) with the same tokens and the same
   drop counts, prefill's and each step's, on the card and on the CPU.
11. MoE path: full-width qwen2-moe-a2.7b (14.3B random bf16 parameters,
   seed 0; 24 layers of 60 routed experts top-4 plus shared experts)
   through ``LM.prefill`` / ``decode_step`` / ``maybe_flush``: 2 prompts
   of 1024 tokens and 32 greedy steps; prefill ms cold and warm, decode ms
   per step, tokens/s, peak memory, the drops of the prefill and of each
   decode step, launches (counters zeroed just before, read just after;
   B2 once per layer per prefill, B3 once per norm), and device time by
   kernel with the idle share of one warm prefill and one decode step.
   Then a diagnostic prefill logs each MoE layer's drops, its busiest
   expert's share and how alike its input tokens are, and re-runs the
   layer that drops most on the CPU from the card's input (drops and
   output beside the card's). Both MoE phases print their wall time.
12. VLM generation reference check: reduced fp32 llama-3.2-vision-90b (4
   layers, 2 of them cross-attention, gates 0.5, 37 frontend tokens)
   generates (prefill, 12 greedy decode steps, flushes every 8) with the
   same tokens on the card and on the CPU, for each of two frontends,
   which must give different tokens.
13. VLM path: llama-3.2-vision-90b at full width with its depth cut to 10
   layers (two super-blocks of 4 self-attention layers and one
   cross-attention layer; 10.66B random bf16 parameters, seed 0, both
   gates of each cross layer set to 0.5), 1601 bf16 frontend embeddings
   from seed 0, through ``LM.prefill`` / ``decode_step`` /
   ``maybe_flush``: 2 prompts of 1024 and 32 greedy steps with a recent
   window of 16 (one flush); prefill ms cold and warm, decode ms per
   step, tokens/s, peak memory, launches (counters zeroed just before,
   read just after: B2 10 times a prefill, 8 causal and 2 not, B3 21
   times a prefill and a step), device time by kernel with the idle share
   of one warm prefill and one decode step.
14. The port's examples (``repro_torch.examples.quickstart`` and
   ``serve_e2e``: autoscaling, an injected failure, a snapshot) run their
   ``main`` on the card; each finishes every request it submitted.
15. Training kernel cases: B2 (bf16, B=2, 4096 x 4096 causal, 32/8 heads
   of 128, and zamba2-7b's 32/32 heads of 112) and B3 (bf16, 8192 x 4096)
   at the training paths' shapes, forward and backward through their
   autograd Functions (forward kernel, then backward kernel), held against
   the plain version's forward and its autograd gradients (2e-2), then
   timed: the forward kernel and the backward kernel
   (``kernels/flash_attention/csrc/flash_attention_bwd.cu`` from the
   forward's logsumexp, three passes, and
   ``kernels/rmsnorm/csrc/rmsnorm_bwd.cu``, two passes: the
   ``flash_attention_bwd`` and ``rmsnorm_bwd`` rows, a line of each pass's
   device time), the closed form in PyTorch ops as their plain column,
   SDPA's or ``F.rms_norm``'s forward and backward beside them, each with
   its bound; a backward device time under its bound raises. Then B4's
   backward kernel (``kernels/ssd_scan/csrc/ssd_scan_bwd.cu``, six passes, the
   backward of ``ssd_scan``'s autograd Function) at B4's cases of item 7
   and at the training shape (mamba2-1.3b's microbatch, bf16 B=2, S=4096,
   64 heads, P=64, N=128, Q=256, from a zero state): every input's
   gradient held against the closed form in PyTorch ops
   (``ssd_scan_bwd``) on the same card tensors, within 1e-4 (fp32) or
   2e-2 (bf16) of its largest magnitude, a case with an initial state
   taking a final-state gradient too; timed (the backward of one retained
   forward) beside autograd of the plain forward and the closed form,
   each pass's device time logged, with its bound
   (``ssd_bwd_bound_work``); a device time under it raises.
16. Training reference check: reduced fp32 granite-3-8b, llama2-7b,
   mamba2-1.3b (4 Mamba layers) and zamba2-7b (3 Mamba layers and 2
   sites of the shared attention block) take 3 train steps (2
   microbatches, AdamW) on the card and on the CPU
   from the same params and batches; every leaf's card gradient exists
   and is finite, and gradients (each leaf relative to its largest value)
   and losses agree within 1e-4, parameters after the steps within 1e-4
   relative plus 0.05 lr (AdamW turns the noise of a near-zero gradient
   into an update difference of up to lr).
17. Training paths (``TRAIN_PATHS``), each at full width with random
   bf16 params from seed 0 and fp32 AdamW state, on sequences of 4096, a
   global batch of 4 as 2 microbatches: granite-3-8b cut to 8 of its 40
   layers (1.80B params; 5 timed steps), mamba2-1.3b with all 48 layers
   (1.34B; each layer under activation checkpointing; 5 timed steps) and
   zamba2-7b cut to 12 of its 81 layers (1.21B; 10 Mamba layers, the
   shared attention block at 2 sites; 2 timed steps), each after one warm
   step; step ms, tokens/s, losses and grad norms (finite, a gate), peak
   memory, model FLOPs over step time over the bf16 peak, launches
   (counters zeroed just before the timed steps, gated per microbatch: B2
   once per attention layer, B3 once per norm, B4's forward once per
   Mamba layer, twice under remat; the backward kernels B2's once per
   attention layer, B3's once per norm, B4's once per Mamba layer),
   and from a profiled step the device time by kernel, the idle share and
   the forward / backward / optimizer shares of device time
   (``train_step.*`` profiler ranges).
18. The training example (``repro_torch.examples.train_example``, the
   reference's counts: 200 steps, 2 microbatches, int8 compression,
   checkpoints every 100) on the card: every loss finite and the last 25
   steps' mean below the first 25's; then a restart from its step-100
   checkpoint runs the other 100 steps.
19. B1 refuses an input that requires grad (RuntimeError, no launch).
20. The Scenario API's compiled whole-trace core
   (``kernels/fastsim/csrc/whole_trace.cu``, reached through
   ``serving/fastsim_jax.py`` as ``engine="jax"``): (a) the small traces
   of ``tests/test_torch_fastsim.py`` (a heterogeneous fleet, the grid
   trace under aladdin and jsq, a lone arrival, two tenants whose backlog
   the EDF sort reorders, a 2/4/6-worker bracket) through the kernel,
   held against its plain version and the numpy core
   (``engine="vectorized"``): integers equal,
   times within 1e-12 relative, report floats within 1e-9, beats equal;
   the largest relative difference is logged. (b) The reference's
   ``scale`` scenario (``benchmarks/bench_cluster_sim.py``, built from the
   port's copies): llama2-70b workers on 4 A100s each at the paper's SLO,
   max batch 32, inert KV; a diurnal trace at 11.574 req/s, amplitude
   0.6, seed 5; its one-tenth slice (864 s at a 0.25 s heartbeat, ~10^4
   requests) on 24 workers, the kernel against the plain version and
   ``engine="jax"`` against ``engine="vectorized"`` request by request,
   each ``run()`` timed apart from the trace's generation
   (``trace_generation_s``). (c) ``optimize()`` on the slice (lo 16, hi
   40, target 0.98) on both engines: the same fleet and attainment;
   evaluations, wall seconds and each bracket launch's device ms (CUDA
   events around the host side's calls). (d) The full day (8640 s at 0.02
   s, ~10^5 requests, 24 workers) on the card in one launch: finished,
   attainment, p99 TTFT, beats, wall and device ms, the wall less the
   device ms (``host_ms``), beats per second. The launch counter is
   zeroed before (c) and read after (d). (e) The kernel's counters
   (``whole_trace(..., stats=)``): ``[fastsim whole split]`` lines for
   the slice, optimize's 40-worker launch and the day, each phase's ms a
   launch at the SM clock nvidia-smi reads meanwhile and the counts,
   beside the recorded split of the kernel before its redesign; a
   counter that disagrees with the outputs (phases over the launch's
   cycles, beats, placements) raises.
21. The chunked core (``kernels/fastsim/csrc/chunk.cu``, ``chunked_phase``):
   every chunk of the pooled twins (``serving/chunk_twins.py``) and a
   hand-made chunk at constraint (c)'s edge through the kernel, states
   equal to the plain version's; the spot cell's first 10 chunks, equal
   and timed, with each chunk's counted work; the kernel's counters over
   one more ``run()`` of the spot and feedback cells (each phase's ms a
   launch at the SM clock nvidia-smi reads meanwhile, tries, placements,
   constraint (e) tests, members), beside the recorded split of the
   kernel before its redesign; then, launch counter zeroed, the
   reference's spot and feedback cells on the card against the numpy
   core request by request (device ms a launch, the host's split),
   ``optimize(policy_space=...)`` on both engines (the same plan), and
   po2 twice (deterministic, within 0.15 of the numpy core).
22. Distribution (``dist_phase``): full-width granite-3-8b (40 layers,
   random bf16 weights from seed 0) under ``make_policy`` on a
   ("data", "model") mesh of spawned ranks on the card (a gloo group
   through a ``file://`` store), every parameter, input and cache leaf a
   DTensor: on one rank (``DIST_RANKS``) a prefill of 2 x 1024 tokens
   (cold, then warm) and 16 greedy decode steps, the logits equal to the
   unsharded ``LM``'s on the same weights and tokens (gated); on two
   ranks (``DIST_TP_RANKS``, heads, d_ff and K/V heads over "model") the
   prefill alone, both ranks' logits alike and within 2e-2 of their
   largest value of the unsharded ``LM``'s (gated); on every rank B2
   once per layer per prefill and B3 2 x 40 + 1 times per prefill and per
   step on the local shards (gated); prefill and decode ms beside the
   unsharded ``LM``'s, each prefill's collectives, device time by kernel
   and idle share of a warm prefill and a step. Then, on the host only,
   ``python -m repro_torch.launch.dryrun`` of granite-3-8b's decode_32k
   and train_4k cells on 256 fake ranks: per-device peak GB, dot FLOPs,
   collective bytes by kind, trace seconds (counts from shapes).
23. Prints ``{"kernels": [...]}``, then, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the repository beside it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM datasheet
# an earlier run of this script (run F), whose engine promoted every
# layer's weights to fp32 on every decode step: the main path's mean decode
# iteration and the breakdown's decode-step wall, NVIDIA H100 80GB HBM3 at
# 700 W
RUN_F_MS = {"main_mean_decode": 48.7, "breakdown_decode_wall": 49.8}
# fp64: outside the tensor cores, where the simulation core computes
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "fp64": 34e12}
TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}

REPLACES = {
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:72",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:76",
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:33",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:70",
    # no TPU kernel: the reference's gradient is XLA's autodiff of this
    "ssd_scan_backward": "src/repro/kernels/ssd_scan/ref.py:68",
    "flash_attention_bwd": "src/repro/kernels/flash_attention/ref.py:106",
    "rmsnorm_bwd": "src/repro/kernels/rmsnorm/ref.py:10",
    "fastsim_whole_trace": "src/repro/serving/fastsim_jax.py:185",
    "fastsim_chunk": "src/repro/serving/fastsim_jax.py:608",
}
SOURCES = {
    "paged_decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rmsnorm": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
    "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
    "ssd_scan_backward":
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
    "rmsnorm_bwd": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
    "fastsim_whole_trace":
        "src/repro_torch/kernels/fastsim/csrc/whole_trace.cu",
    "fastsim_chunk": "src/repro_torch/kernels/fastsim/csrc/chunk.cu",
}
# the port's kernels by a stem of their device function names
PORT_KERNELS = {"paged_decode_attention": "paged_decode_kernel",
                "flash_attention": "flash_fwd_", "rmsnorm": "rmsnorm_kernel",
                "ssd_scan": "ssd_scan_kernel",
                "ssd_scan_backward": "ssd_bwd_kernel",
                "flash_attention_bwd": "flash_bwd_",
                "rmsnorm_bwd": "rmsnorm_bwd_"}
# the backward kernels' launch counters (the wrappers' names) by row name
BWD_COUNTERS = {"flash_attention_bwd": "flash_attention_backward",
                "rmsnorm_bwd": "rmsnorm_backward"}
SSD_PASSES = 3                             # B4's kernels per call
SSD_BWD_PASSES = 6                         # B4's backward kernels per call
FLASH_BWD_PASSES = 3                       # B2's backward kernels (bf16)
RMSNORM_BWD_PASSES = 2                     # B3's backward kernels
# B4's cases (B, S, H, P, G, N, Q, type, initial state) at the mamba2-1.3b
# and zamba2-7b prefill shapes, ragged S in fp32 and bf16, a two-group
# case; the card-filling case at batch 1 comes last, so the seeded draws of
# the cases before it stay as they were
SSD_CASES = ((4, 2048, 64, 64, 1, 128, 256, "bf16", True),
             (4, 2048, 64, 64, 1, 128, 256, "bf16", False),
             (1, 2048, 64, 64, 1, 128, 256, "fp32", True),
             (1, 1000, 64, 64, 1, 128, 256, "fp32", True),
             (2, 1024, 112, 64, 1, 64, 256, "bf16", False),
             (2, 256, 2, 64, 2, 32, 64, "fp32", True),
             (2, 1000, 64, 64, 1, 128, 256, "bf16", False),
             (1, 2048, 64, 64, 1, 128, 256, "bf16", False))
# B4's backward also at the training path's shape: a mamba2-1.3b
# microbatch of 2 x 4096 tokens from a zero state
SSD_TRAIN_CASE = (2, 4096, 64, 64, 1, 128, 256, "bf16", False)
BWD_TOL = {"fp32": 1e-4, "bf16": 2e-2}     # of each gradient's largest
L2_BYTES = 50 * 2 ** 20                    # H100 L2 cache
# B1's cases at the engine's pool, (batch, Hq, Hkv, type); then the main
# path's ragged batch: PagedEngine decodes all 8 slots, an idle one with
# length 1 on the null page
B1_CASES = ((1, 32, 32, "fp32"), (8, 32, 32, "fp32"), (8, 32, 8, "fp32"),
            (8, 32, 32, "bf16"))
MAIN_PATH_LENGTHS = (960, 544, 160, 1, 1, 1, 1, 1)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)     # SSD final state, as the
                                           # reference's test_ssd_sweep
# both tanh gates of every VLM cross layer: zero at init, where a cross
# layer adds nothing and the frontend would not matter
VLM_GATE = 0.5
# the training paths (arch, layers, timed steps, remat): granite-3-8b cut
# to 8 of its 40 layers (parameters, gradients and fp32 AdamW state of all
# 40 exceed the card's 80 GB); mamba2-1.3b whole, each layer under
# activation checkpointing (~24 GB of parameters and optimizer state, and
# ~1.2 GB of activations a layer a microbatch without it); zamba2-7b cut to
# 12 of its 81 layers, 10 Mamba layers and 2 sites of the shared attention
# block, so that B2, B3 and B4 all run forward and backward in one step.
# Then granite's attention (B, S, Hq, Hkv, D) and norm rows (B * S,
# d_model) per microbatch
TRAIN_PATHS = (("granite-3-8b", 8, 5, False), ("mamba2-1.3b", 48, 5, True),
               ("zamba2-7b", 12, 2, False))
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 4096, 4, 2
TRAIN_ATTN = (2, 4096, 32, 8, 128)
TRAIN_ATTN_ZAMBA = (2, 4096, 32, 32, 112)   # zamba2-7b's shared block
TRAIN_NORM = (8192, 4096)


def log(*a) -> None:
    print(*a, flush=True)


def bound(nbytes: float, ops: dict):
    """Least time (ms) and what bounds it: the larger of ``nbytes`` over
    the memory rate and the operations over the peak rate of their type,
    ``ops`` mapping a type to its operations (the types' times added)."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = sum(f / PEAK_FLOPS[kind] for kind, f in ops.items())
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops
            else "operations")


def record(cases, kernel, case, kind, err, k_ms, p_ms, l_ms, nbytes, ops,
           tol=None, dev=(None, None)) -> None:
    """Append one kernel-phase case to ``cases`` and log it. ``dev`` holds
    the device time per call of the kernel and of the library call."""
    b_ms, b_by = bound(nbytes, ops)
    row = {"kernel": kernel, "case": case, "dtype": kind,
           "max_abs_err": err, "tol": tol or TOL[kind], "kernel_ms": k_ms,
           "device_ms": dev[0], "plain_ms": p_ms, "library_ms": l_ms,
           "library_device_ms": dev[1], "bound_ms": b_ms, "bound_by": b_by}
    cases.append(row)
    log(json.dumps(row))


class Timer:
    """Mean device time of one call, from CUDA events around a run of
    calls after a warm-up."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, budget_ms: float = 60.0) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        iters = int(min(max(budget_ms / max(once, 1e-3), 3), 200))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def device_ms(torch, fn, n: int = 20, stem: str | None = None,
              per_call: int = 1) -> float:
    """Device time per call of ``fn``; unlike the host-clock ``Timer``,
    launch and wrapper overhead on the host do not count.

    From torch.profiler over ``n`` calls after a warm-up: for each device
    operation, its mean time a launch times its launches a call (at least
    one, so a launch the profiler missed does not shrink the sum). The
    reading is kept only if the profiler saw device time and, where
    ``stem`` names the port's kernel, every launch of a kernel of that
    name: ``per_call`` launches (one per pass) in each of the ``n`` calls,
    so a pass the profiler missed entirely is not left out. Otherwise
    (some profilers drop kernels, or trace no device at all) the time
    comes from ``queued_ms``, and a line says so.
    """
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count \
                and e.self_device_time_total > 0:
            total += e.self_device_time_total / e.count / 1e3 \
                * max(1, round(e.count / n))
            if stem is not None and stem in e.key:
                seen += e.count
    if total and (stem is None or seen >= n * per_call):
        return total
    ms = queued_ms(torch, fn, n)
    log(f"[timing] the profiler saw {seen} of {n * per_call} launches of "
        f"{stem or 'any kernel'} ({total:.4g} ms a call); device time from "
        f"queued CUDA events instead: {ms:.4g} ms a call")
    return ms


def queued_ms(torch, fn, n: int = 20) -> float:
    """Device time per call of ``fn`` from CUDA events around ``n`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts
    their launches on the host, so that the device runs them back to back:
    host overhead does not count, the gaps between launches on the device
    do. The spin is sized from one synchronous call on the host clock
    (assuming a clock of at most 2 GHz), and lengthened until the start
    event is still pending once the last call is queued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once_ms = (time.perf_counter() - t0) * 1e3
    cycles = int(2 * n * once_ms * 2e6) + 2_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        pending = not start.query()
        torch.cuda.synchronize()
        if pending:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise AssertionError("queued_ms: the spin kernel never outlasted the "
                         "launches")


def cold_sets(tensors, read_bytes: float) -> list:
    """``tensors`` and enough clones of them that a cycle of calls, each
    reading ``read_bytes`` of its own set, reads more than twice the 50 MB
    L2: a call then finds its inputs cold, as each layer of the engine
    finds its own pool."""
    n = max(2, int(2 * L2_BYTES // read_bytes) + 1)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def cycling(fn, sets):
    """A call of ``fn`` on the next of ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def pass_ms(torch, fn, stem: str, n: int = 5) -> dict:
    """Device ms per call of each kernel named ``<stem>_<name>`` (the
    passes of B4, the splits and merge of B1; ``<stem>`` alone for a kernel
    of one pass), from torch.profiler over ``n`` calls, with the launches
    it saw."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count \
                and stem in e.key:
            name = e.key.split(stem, 1)[1].lstrip("_")
            name = name.split("<")[0].split("(")[0] or stem
            out[name] = {"ms": e.self_device_time_total / e.count / 1e3,
                         "seen": e.count}
    return out


def paged_work(q, kp, bt, lengths, kind):
    """Bytes and operations (by type) of the least work of one B1 call:
    the live tokens' K and V, q and out, the block table and the lengths
    each moved once; QK and PV over the live tokens. The splits' partials
    are the kernel's own scratch and are not counted."""
    b, hq, hd = q.shape
    hkv = kp.shape[2]
    toks = float(lengths.sum())
    esz = q.element_size()
    nbytes = (2 * toks * hkv * hd + 2 * b * hq * hd) * esz \
        + bt.numel() * 4 + b * 4
    return nbytes, {kind: 4.0 * toks * hq * hd}


def paged_case(torch, timer, cases, q, kp, vp, bt, lengths, kind,
               case) -> None:
    """One B1 case: held against the plain version, then timed cold (each
    call on the next of ``cold_sets``' pools) on the host loop and as
    device time per call, beside the plain version (warm); logs the split
    plan, each of its two kernels' profiler time and the wrapper's host
    time per call, and raises if the device time falls under the bound.
    The device time is ``queued_ms``'s (calls back to back behind a spin):
    the merge kernel is a programmatic dependent of the split kernel and is
    staged while that one drains, so the profiler's two durations overlap
    and their sum would count the overlap twice."""
    from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                      paged_decode_ref,
                                                      split_plan)
    b, hq, hd = q.shape
    _, page, hkv, _ = kp.shape
    max_pages = bt.shape[1]
    what = f"paged decode {case} {kind}"
    err = check_close(torch, paged_decode_attention(q, kp, vp, bt, lengths),
                      paged_decode_ref(q, kp, vp, bt, lengths), kind, what)
    nbytes, ops = paged_work(q, kp, bt, lengths, kind)
    read = 2 * float(lengths.sum()) * hkv * hd * q.element_size()
    pools = cold_sets((kp, vp), read)
    kern = cycling(lambda k, v: paged_decode_attention(q, k, v, bt, lengths),
                   pools)
    stem = PORT_KERNELS["paged_decode_attention"]
    pages, splits = split_plan(b, hkv, max_pages, page)
    record(cases, "paged_decode_attention", case, kind, err, timer(kern),
           timer(lambda: paged_decode_ref(q, kp, vp, bt, lengths)), None,
           nbytes, ops,
           dev=(queued_ms(torch, kern, n=50), None))
    span, cap = pages * page, max_pages * page
    live = sum(-(-(n if n > 0 else cap) // span)
               for n in lengths.clamp(max=cap).tolist()) * hkv
    log(f"[paged_decode split] {case} {kind}: " + json.dumps({
        "pages_per_split": pages, "positions_per_split": span,
        "splits": splits, "ctas": splits * hkv * b, "live_ctas": live,
        "cold_pool_sets": len(pools),
        "kernels_ms": pass_ms(torch, kern, stem),
        "wrapper_host_us": host_us(torch, kern)}))
    row = cases[-1]
    if row["device_ms"] < row["bound_ms"]:
        raise AssertionError(f"{what}: device time {row['device_ms']} ms "
                             f"under its bound {row['bound_ms']} ms")


def ptxas_report(text: str, stem: str) -> dict:
    """Registers and spill bytes of each compiled function whose name holds
    ``stem``, from ptxas's ``-v`` report (names cut to the stem and the
    mangled template arguments)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Function properties for |entry function ')"
                      r"([A-Za-z0-9_]+)", line)
        if m:
            name = m.group(1)
            name = (name[name.index(stem):].split("Ev")[0]
                    if stem in name else None)
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def check_close(torch, got, want, kind: str, what: str,
                tol=None) -> float:
    tol = tol or TOL[kind]
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, **tol):
        raise AssertionError(f"{what}: max abs err {err} outside {tol}")
    return err


def host_us(torch, fn, n: int = 200) -> float:
    """Host time per call (us) of ``fn`` queued ``n`` times without a
    synchronise: what the calling thread spends, not the device. ``n``
    stays under the launch queue's depth, so the loop never waits for the
    card."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def rmsnorm_host_split(torch, F, x, w) -> None:
    """Log where B3's wrapper spends its host time, in us per call (the
    least of 5 loops of 200 calls): the checks, reading the stream (raw
    handle, and through a torch.cuda.Stream object as before), the
    allocation, and the launch through the CPython binding, beside the
    whole wrapper and F.rms_norm."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ops
    rows, d = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), None, w.data_ptr(), y.data_ptr(), rows, d, 1e-5,
            x.dtype is torch.bfloat16, w.dtype is torch.bfloat16, stream)
    ext = _build.module()
    split = {
        "wrapper": host_us(torch, lambda: ops.rmsnorm(x, w, eps=1e-5)),
        "F.rms_norm": host_us(torch, lambda: F.rms_norm(x, (d,), w, 1e-5)),
        "checks": host_us(torch, lambda: ops._check(x, w, None)),
        "stream_raw": host_us(torch, lambda: torch._C._cuda_getCurrentRawStream(
            x.get_device())),
        "stream_object": host_us(torch, lambda: torch.cuda.current_stream(
            x.device).cuda_stream),
        "alloc": host_us(torch, lambda: torch.empty_like(x)),
        "launch_binding": host_us(torch, lambda: ext.rmsnorm(*args)),
    }
    torch.cuda.synchronize()
    log(f"[rmsnorm host us/call] {rows}x{d} {str(x.dtype)[6:]}: "
        + json.dumps({k: round(v, 3) for k, v in split.items()}))


def rmsnorm_refusals(torch, dev) -> None:
    """B3's wrapper raises on each input of a CUDA tensor that its checks
    refuse, with the same error type as every earlier version."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = torch.zeros((4, 64), device=dev, dtype=torch.bfloat16)
    w = torch.ones((64,), device=dev, dtype=torch.bfloat16)
    bad = {
        "x fp16": (TypeError, (x.half(), w, None)),
        "w int32": (TypeError, (x, w.int(), None)),
        "w (32,)": (ValueError, (x, w[:32], None)),
        "w (1, 64)": (ValueError, (x, w[None], None)),
        "w on the CPU": (ValueError, (x, w.cpu(), None)),
        "x not contiguous": (ValueError, (x.t(), w[:4], None)),
        "w not contiguous": (ValueError, (x, torch.ones((64, 2), device=dev,
                                           dtype=torch.bfloat16)[:, 0], None)),
        "residual fp32": (ValueError, (x, w, x.float())),
        "residual (4, 32)": (ValueError, (x, w, x[:, :32])),
        "residual not contiguous": (ValueError, (x, w, torch.zeros(
            (4, 128), device=dev, dtype=torch.bfloat16)[:, ::2])),
    }
    for what, (err, args) in bad.items():
        try:
            rmsnorm(*args)
        except err:
            continue
        except Exception as e:             # the wrong error type
            raise AssertionError(f"rmsnorm with {what}: {type(e).__name__}"
                                 f" where {err.__name__} was expected")
        raise AssertionError(f"rmsnorm took {what}")
    log(f"[rmsnorm] refuses, as before, each of {len(bad)} bad CUDA inputs: "
        + ", ".join(bad))


def kernel_phases(torch, F, timer):
    from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                      paged_decode_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- B3 RMSNorm: prefill rows in bf16, decode rows in fp32 ------------
    def rmsnorm_cases(shapes):
        for rows, d, kind, with_res in shapes:
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            x = randn((rows, d), dt)
            w = randn((d,), torch.bfloat16)          # weights are bf16 params
            r = randn((rows, d), dt) if with_res else None
            err = check_close(torch, rmsnorm(x, w, r, eps=1e-5),
                              rmsnorm_ref(x, w, r, 1e-5), kind,
                              f"rmsnorm {rows}x{d} {kind}")

            def kern():
                return rmsnorm(x, w, r, eps=1e-5)
            if r is None and dt == w.dtype:
                rmsnorm_host_split(torch, F, x, w)
            k_ms = timer(kern)
            p_ms = timer(lambda: rmsnorm_ref(x, w, r, 1e-5))
            l_ms = l_dev = None
            if r is None and dt == w.dtype:
                def lib():
                    return F.rms_norm(x, (d,), w, 1e-5)
                l_ms, l_dev = timer(lib), device_ms(torch, lib)
            n_in = rows * d * (2 if with_res else 1)
            nbytes = (n_in + rows * d) * x.element_size() \
                + d * w.element_size()
            flops = rows * d * (4 + (1 if with_res else 0))
            record(cases, "rmsnorm",
                   f"{rows}x{d}{' +residual' if with_res else ''}", kind, err,
                   k_ms, p_ms, l_ms, nbytes, {kind: flops},
                   dev=(device_ms(torch, kern,
                                  stem=PORT_KERNELS["rmsnorm"]), l_dev))

    # ---- B2 flash attention: prefill buckets in bf16, chunked in fp32 -----
    def attn_pairs(sq, skv, q_offset, kv_hi):
        rows = torch.arange(sq, dtype=torch.float64) + q_offset + 1
        return float(torch.clamp(rows, max=kv_hi).sum())

    def flash_cases(shapes):
        """Each shape: (B, Sq, Skv, Hq, Hkv, D, type, q_offset, kv_len)
        and, optionally, causal (default True)."""
        for b, sq, skv, hq, hkv, hd, kind, q_offset, kv_len, *rest in \
                shapes:
            causal = rest[0] if rest else True
            dt = torch.bfloat16 if kind == "bf16" else torch.float32
            q = randn((b, sq, hq, hd), dt)
            k = randn((b, skv, hkv, hd), dt)
            v = randn((b, skv, hkv, hd), dt)
            kl = None if kv_len is None else torch.tensor(
                [kv_len] * b, dtype=torch.int32, device=dev)

            def kern():
                return flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset, kv_len=kl)

            def plain():
                return flash_attention_ref(q, k, v, causal=causal,
                                           q_offset=q_offset, kv_len=kl)
            err = check_close(torch, kern(), plain(), kind,
                              f"flash B={b} {sq}x{skv} {hq}/{hkv} D={hd} "
                              f"{kind}{'' if causal else ' non-causal'}")
            # SDPA as the yardstick: causal, unmasked (cross), or with a
            # boolean mask built here, outside the timed call, for a
            # q_offset or kv_len
            kv_hi = skv if kv_len is None else kv_len
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_kw = {"enable_gqa": True} if hq != hkv else {}
            if causal and q_offset == 0 and kv_len is None and sq == skv:
                sdpa_kw["is_causal"] = True
            elif causal or kv_len is not None:
                qpos = torch.arange(sq, device=dev)[:, None] + q_offset
                kpos = torch.arange(skv, device=dev)[None, :]
                mask = kpos < kv_hi
                sdpa_kw["attn_mask"] = mask & (kpos <= qpos) if causal \
                    else mask

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
            l_ms, l_dev = timer(lib), device_ms(torch, lib)
            pairs = attn_pairs(sq, skv, q_offset, kv_hi) if causal \
                else float(sq * kv_hi)
            esz = q.element_size()
            nbytes = b * (2 * sq * hq * hd + 2 * kv_hi * hkv * hd) * esz
            flops = 4.0 * b * pairs * hq * hd
            case = f"B={b} Sq={sq} Skv={skv} H={hq}/{hkv} D={hd}" + (
                f" q_offset={q_offset} kv_len={kv_len}" if q_offset
                else "") + ("" if causal else " non-causal")
            record(cases, "flash_attention", case, kind, err, timer(kern),
                   timer(plain), l_ms, nbytes, {kind: flops},
                   dev=(device_ms(torch, kern,
                                  stem=PORT_KERNELS["flash_attention"]),
                        l_dev))

    # The llama2-7b shapes come first and in a fixed order: the seeded draws
    # before B1 decide its lengths, so its timed case stays the same from
    # run to run. The other models' shapes follow B1.
    rmsnorm_refusals(torch, dev)
    rmsnorm_cases(((1024, 4096, "bf16", False), (64, 4096, "bf16", False),
                   (8, 4096, "fp32", False), (1024, 4096, "bf16", True),
                   (8, 4096, "fp32", True)))
    flash_cases(((1, 128, 128, 32, 32, 128, "bf16", 0, None),
                 (1, 512, 512, 32, 32, 128, "bf16", 0, None),
                 (1, 1024, 1024, 32, 32, 128, "bf16", 0, None),
                 (1, 1024, 1024, 32, 8, 128, "bf16", 0, None),
                 (1, 256, 768, 32, 32, 128, "fp32", 512, 768),
                 (1, 256, 768, 32, 32, 128, "bf16", 512, 700)))

    # ---- B1 paged decode over the engine's page pool, timed cold ----------
    for b, hq, hkv, kind in B1_CASES:
        inputs = paged_inputs(torch, gen, b, hq, hkv, kind)
        paged_case(torch, timer, cases, *inputs, kind,
                   f"B={b} H={hq}/{hkv} D=128 page=16 max_pages=64 "
                   f"lengths<=1024")

    # mamba2-1.3b (d 2048: 4 x 2048 prefill rows, batch-4 decode rows) and
    # zamba2-7b (d 3584: 2 x 1024 prefill rows, batch-2 decode rows; its
    # attention heads of 112); then B2 at the edges of its tiling: a ragged
    # Sq, D = 64, and the 64-token bucket (one 64-row tile a head)
    rmsnorm_cases(((8192, 2048, "bf16", False), (4, 2048, "bf16", False),
                   (2048, 3584, "bf16", False), (2, 3584, "bf16", False)))
    flash_cases(((2, 1024, 1024, 32, 32, 112, "bf16", 0, None),
                 (2, 1000, 1000, 32, 32, 112, "bf16", 0, None),
                 (1, 512, 512, 16, 16, 64, "bf16", 0, None),
                 (1, 64, 64, 32, 32, 128, "bf16", 0, None)))

    # ---- fully masked rows (C7): no visible key -> mean of V, as the plain
    # versions softmax all -1e30 logits to uniform weights ----------------
    for kind in ("fp32", "bf16"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q, k, v = (randn(s, dt) for s in ((2, 64, 8, 128), (2, 200, 4, 128),
                                          (2, 200, 4, 128)))
        kl = torch.tensor([0, 150], dtype=torch.int32, device=dev)
        for off in (0, 136):
            err = check_close(
                torch, flash_attention(q, k, v, causal=True, q_offset=off,
                                       kv_len=kl),
                flash_attention_ref(q, k, v, causal=True, q_offset=off,
                                    kv_len=kl), kind,
                f"flash kv_len=[0, 150] q_offset={off} {kind}")
            log(f"[c7] flash_attention kv_len=[0, 150] q_offset={off} {kind}:"
                f" max abs err {err:.3g} against the plain version")
        kp, vp = randn((32, 16, 4, 128), dt), randn((32, 16, 4, 128), dt)
        bt = torch.randint(0, 32, (3, 4), generator=gen, device=dev,
                           dtype=torch.int32)
        ln = torch.tensor([0, 33, 64], dtype=torch.int32, device=dev)
        q = randn((3, 16, 128), dt)
        err = check_close(torch, paged_decode_attention(q, kp, vp, bt, ln),
                          paged_decode_ref(q, kp, vp, bt, ln), kind,
                          f"paged decode lengths=[0, 33, 64] {kind}")
        log(f"[c7] paged_decode_attention lengths=[0, 33, 64] {kind}: max "
            f"abs err {err:.3g} against the plain version")

    # ---- B1 at the main path's ragged batch (last: the draws above stay)
    inputs = paged_inputs(torch, gen, 8, 32, 32, "fp32", MAIN_PATH_LENGTHS)
    paged_case(torch, timer, cases, *inputs, "fp32",
               "B=8 H=32/32 D=128 page=16 max_pages=64 lengths=960,544,160"
               " +5 idle")

    # qwen2-moe-a2.7b (d 2048, 16/16 heads of 128: 2 x 1024 prefill rows,
    # batch-2 decode rows), after all of the above so its draws stay
    rmsnorm_cases(((2048, 2048, "bf16", False), (2, 2048, "bf16", False)))
    flash_cases(((2, 1024, 1024, 16, 16, 128, "bf16", 0, None),))

    # llama-3.2-vision-90b (d 8192, 64 heads over 8 of 128: 2 x 1024
    # prefill rows, batch-2 decode rows; 1601 frontend keys, the last
    # 64-key tile holding one), after all of the above so its draws stay:
    # the cross-attention prefill (non-causal) in bf16, and in fp32 as an
    # fp32 frontend's mixed-dtype route runs it; the self-attention prefill
    rmsnorm_cases(((2048, 8192, "bf16", False), (2, 8192, "bf16", False)))
    flash_cases(((2, 1024, 1601, 64, 8, 128, "bf16", 0, None, False),
                 (2, 1024, 1024, 64, 8, 128, "bf16", 0, None),
                 (1, 256, 1601, 64, 8, 128, "fp32", 0, None, False)))
    return cases


def paged_inputs(torch, gen, b, hq, hkv, kind, lengths=None):
    """A B1 case on the engine's pool (512 pages of 16 positions, 64 pages
    a sequence, D 128), on the card: q, the K and V pools, the block table
    and the lengths, drawn from ``gen``. Without ``lengths`` they are
    random in [1, 1024] with the first sequence full; with them, a length
    of 1 is an idle slot (an all-zero block-table row: the null page, as
    ``PagedEngine._decode`` passes it). Live sequences get distinct pages."""
    n_pages, page, max_pages, hd = 512, 16, 64, 128
    dev = "cuda"
    dt = torch.bfloat16 if kind == "bf16" else torch.float32

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    q = randn((b, hq, hd))
    kp = randn((n_pages, page, hkv, hd))
    vp = randn((n_pages, page, hkv, hd))
    idle = [False] * b
    if lengths is None:
        lengths = torch.randint(1, max_pages * page + 1, (b,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[0] = max_pages * page                      # one full seq
    else:
        idle = [n == 1 for n in lengths]
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    bt = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    used = 0
    for i in range(b):                       # distinct pages; rest -> null
        if idle[i]:
            continue
        n = -(-int(lengths[i]) // page)
        if used + n > n_pages - 1:
            used = 0
        bt[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    return q, kp, vp, bt, lengths


def ssd_bound_work(b, s, h, p, g, n, q, kind, init):
    """Bytes and operations (by type) of the least work of one B4 call as
    the three-pass kernel does it: C B^T once per (batch, chunk, group)
    over the lower triangle at the input type's rate; per (batch, head,
    chunk) the masked scores times x, y_inter and the chunk state, each
    with one fp32 operand, as two bf16 passes (hi and lo) for bf16 inputs
    and at the fp32 rate for fp32 inputs. Bytes: x and y, B and C, dt, A
    and D, and the states in and out, each once. The kernel's scratch (the
    chunk states and entering states) is not counted: the scan does not
    need it, only this design does."""
    cbt = rest = 0.0
    for c0 in range(0, s, q):
        lc = min(q, s - c0)
        tri = lc * (lc + 1) / 2
        cbt += b * g * tri * n * 2
        rest += b * h * (tri * p * 2 + 2 * lc * n * p * 2)
    ops = ({"bf16": cbt + 2 * rest} if kind == "bf16"
           else {"fp32": cbt + rest})
    esz = 2 if kind == "bf16" else 4
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * esz \
        + b * s * h * 4 + 2 * h * 4 \
        + (2 if init else 1) * b * h * p * n * 4
    return nbytes, ops


def ssd_kernel_phase(torch, timer):
    """B4 at the Mamba-2 prefill's shapes, held against its plain version
    (``ssd_chunked_ref``, or ``ssd_ref`` at a ragged S) and timed beside
    it. No single PyTorch call computes the SSD scan: library_ms is None.
    The bound is ``ssd_bound_work``'s; a device time under it means the
    count is wrong, and raises. Each pass's device time is logged."""
    from repro_torch.kernels.ssd_scan import (ssd_chunked_ref, ssd_ref,
                                              ssd_scan)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for b, s, h, p, g, n, q, kind, init in SSD_CASES:
        dt_ = torch.bfloat16 if kind == "bf16" else torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(b, s, h, p).to(dt_)
        bm, cm = randn(b, s, g, n).to(dt_), randn(b, s, g, n).to(dt_)
        dtv = torch.rand((b, s, h), generator=gen, device=dev) * 0.099 + 0.001
        a = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
        d = randn(h)
        st = randn(b, h, p, n) * 0.1 if init else None

        def kern():
            return ssd_scan(x, dtv, a, bm, cm, d, st, chunk=q)

        def plain():
            if s % q:
                return ssd_ref(x, dtv, a, bm, cm, d, st)
            return ssd_chunked_ref(x, dtv, a, bm, cm, d, st, chunk=q)
        (y, fin), (y_p, fin_p) = kern(), plain()
        what = f"ssd_scan B={b} S={s} H={h} P={p} G={g} N={n} {kind}"
        err = max(check_close(torch, y, y_p, kind, what + " y"),
                  check_close(torch, fin, fin_p, "fp32", what + " state",
                              STATE_TOL))
        nbytes, ops = ssd_bound_work(b, s, h, p, g, n, q, kind, init)
        case = f"B={b} S={s} H={h} P={p} G={g} N={n} Q={q}" + (
            " init" if init else "")
        log(f"[ssd_scan passes] {case} {kind}: "
            + json.dumps(pass_ms(torch, kern, PORT_KERNELS["ssd_scan"])))
        record(cases, "ssd_scan", case, kind, err, timer(kern),
               timer(plain), None, nbytes, ops,
               tol={"y": TOL[kind], "state": STATE_TOL},
               dev=(device_ms(torch, kern, n=5, stem=PORT_KERNELS["ssd_scan"],
                              per_call=SSD_PASSES), None))
        row = cases[-1]
        if row["device_ms"] < row["bound_ms"]:
            raise AssertionError(f"{what}: device time {row['device_ms']} "
                                 f"ms under its bound {row['bound_ms']} ms:"
                                 " the bound's count is wrong")
    return cases


def ssd_bwd_bound_work(b, s, h, p, g, n, q, kind, init, dfinal):
    """Bytes and operations (by type) of the least work of one B4 backward
    call, written like ``ssd_bound_work``: C B^T once per (batch, chunk,
    group) and dy x^T once per (batch, chunk, head) over the lower triangle,
    both exact at the input type's rate; per (batch, chunk, head) the three
    products of the masked scores (dC, dB, dx) and the four of the states
    (the reverse carry's sum exp(cum) dy^T C, E^T dy, G B and G^T x), each
    with one fp32 operand: two bf16 passes (hi and lo) for bf16 inputs, the
    fp32 rate for fp32 inputs. Bytes: x, dy, B, C, dt, A, D, the initial
    state and the final state's gradient read once, and dx, dB, dC, ddt,
    dA, dD and dinit written once. The forward's scratch and the
    backward's are not counted: the gradient does not need them, only this
    design does."""
    exact = rest = 0.0
    for c0 in range(0, s, q):
        lc = min(q, s - c0)
        tri = lc * (lc + 1) / 2
        exact += b * g * tri * n * 2 + b * h * tri * p * 2
        rest += b * h * (tri * (2 * n + p) * 2 + 4 * lc * n * p * 2)
    ops = ({"bf16": exact + 2 * rest} if kind == "bf16"
           else {"fp32": exact + rest})
    esz = 2 if kind == "bf16" else 4
    nbytes = (3 * b * s * h * p + 4 * b * s * g * n) * esz \
        + 2 * b * s * h * 4 + 4 * h * 4 \
        + (1 + int(init) + int(dfinal)) * b * h * p * n * 4
    return nbytes, ops


def ssd_bwd_phase(torch, timer, smi):
    """B4's backward kernel (``ssd_scan_backward``, the backward of
    ``ssd_scan``'s autograd Function) at the forward phase's cases
    (``SSD_CASES``) and the training shape (``SSD_TRAIN_CASE``): every
    input's gradient through the Function (forward kernel, then backward
    kernel) held against ``ssd_scan_bwd`` (the closed form in PyTorch ops)
    on the same card tensors, within ``BWD_TOL`` of the gradient's largest
    magnitude; a case with an initial state also takes a final-state
    gradient, the others, as training, none. Then timed: the backward of one
    retained forward, called again and again, beside autograd of the plain
    forward (``ssd_chunked_ref``, or ``ssd_ref`` at a ragged S) and the
    closed form, with its bound (``ssd_bwd_bound_work``); a device time
    under it raises. Each pass's device time is logged. No PyTorch call
    computes the SSD backward: library_ms is None."""
    from repro_torch.kernels.ssd_scan import (ssd_chunked_ref, ssd_ref,
                                              ssd_scan, ssd_scan_bwd)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    names = ("dx", "ddt", "dA", "dBm", "dCm", "dD", "dinit")
    for b, s, h, p, g, n, q, kind, init in SSD_CASES + (SSD_TRAIN_CASE,):
        dt_ = torch.bfloat16 if kind == "bf16" else torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(b, s, h, p).to(dt_)
        bm, cm = randn(b, s, g, n).to(dt_), randn(b, s, g, n).to(dt_)
        dtv = torch.rand((b, s, h), generator=gen, device=dev) * 0.099 + 0.001
        a = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
        d = randn(h)
        st = randn(b, h, p, n) * 0.1 if init else None
        dy = randn(b, s, h, p).to(dt_)
        dfin = randn(b, h, p, n) if init else None
        inputs = [x, dtv, a, bm, cm, d] + ([st] if init else [])
        cot = [dy, dfin] if init else [dy]

        def graph(fn):
            """fn's outputs (with the final state where it has a gradient)
            on copies of the inputs that require grad, and the copies."""
            xs = [t.detach().requires_grad_() for t in inputs]
            y, fin = fn(*xs[:6], xs[6] if init else None)
            return [y, fin][:len(cot)], xs

        def kern(*t):
            return ssd_scan(*t, chunk=q)

        def plain(*t):
            return ssd_ref(*t) if s % q else ssd_chunked_ref(*t, chunk=q)
        outs, xs = graph(kern)
        got = torch.autograd.grad(outs, xs, cot, retain_graph=True)
        want = ssd_scan_bwd(*inputs[:6], st, dy, dfin, chunk=q)
        what = f"ssd_scan_backward B={b} S={s} H={h} P={p} G={g} N={n} {kind}"
        torch.cuda.synchronize()
        errs, rels = [], []
        for name, gk, gw in zip(names, got, want):
            if gk.shape != gw.shape or gk.dtype != gw.dtype \
                    or not bool(torch.isfinite(gk.float()).all()):
                raise AssertionError(f"{what} {name}: {gk.shape}/{gk.dtype}"
                                     f" vs {gw.shape}/{gw.dtype}, or not "
                                     "finite")
            diff = float((gk.float() - gw.float()).abs().max())
            rel = diff / max(float(gw.float().abs().max()), 1e-30)
            if rel > BWD_TOL[kind]:
                raise AssertionError(f"{what} {name}: max abs err {diff}, "
                                     f"{rel:.3g} of the largest, outside "
                                     f"{BWD_TOL[kind]}")
            errs.append(diff)
            rels.append(rel)

        def kern_b():
            return torch.autograd.grad(outs, xs, cot, retain_graph=True)
        k_ms = timer(kern_b)
        log(f"[ssd_scan_backward passes] {what}: "
            + json.dumps(pass_ms(torch, kern_b,
                                 PORT_KERNELS["ssd_scan_backward"])))
        k_dev = device_ms(torch, kern_b, n=5,
                          stem=PORT_KERNELS["ssd_scan_backward"],
                          per_call=SSD_BWD_PASSES)
        del got, want
        closed_ms = timer(lambda: ssd_scan_bwd(*inputs[:6], st, dy, dfin,
                                               chunk=q))
        p_outs, p_xs = graph(plain)

        def plain_b():
            return torch.autograd.grad(p_outs, p_xs, cot, retain_graph=True)
        p_ms = timer(plain_b)
        del p_outs, p_xs, outs, xs
        gc.collect()
        torch.cuda.empty_cache()
        nbytes, ops = ssd_bwd_bound_work(b, s, h, p, g, n, q, kind, init,
                                         init)
        case = f"B={b} S={s} H={h} P={p} G={g} N={n} Q={q}" + (
            " init dfinal" if init else "")
        log(f"[ssd_scan_backward] {case} {kind}: each gradient's max abs "
            f"err " + json.dumps(dict(zip(names, errs)))
            + f", of its largest {max(rels):.3g}; closed form "
            f"(ssd_scan_bwd) {closed_ms:.4g} ms")
        record(cases, "ssd_scan_backward", case, kind, max(errs), k_ms, p_ms,
               None, nbytes, ops, tol={"of_largest": BWD_TOL[kind]},
               dev=(k_dev, None))
        row = cases[-1]
        if row["device_ms"] < row["bound_ms"]:
            raise AssertionError(f"{what}: device time {row['device_ms']} "
                                 f"ms under its bound {row['bound_ms']} ms:"
                                 " the bound's count is wrong")
    log(f"[ssd_scan_backward] card {smi}")
    return cases


def reference_check(torch):
    """Reduced fp32 models: the engine on the card (kernels) and on the CPU
    (plain versions) must generate identical tokens."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.request import ReqState, Request
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    for name, d_model in (("llama2-7b", 512), ("granite-3-8b", 256)):
        arch = dataclasses.replace(
            reduced(get_arch(name), n_layers=2, d_model=d_model, vocab=512),
            param_dtype="float32")
        cpu = LM(arch, device="cpu").init(torch.Generator().manual_seed(1))
        cuda = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.cuda())
                for k, v in cpu.items()}
        for chunk in (0, 16):
            outs = []
            for params, device in ((cpu, "cpu"), (cuda, "cuda")):
                eng = PagedEngine(arch, params, EngineConfig(
                    max_batch=4, page_size=16, n_pages=64,
                    max_pages_per_seq=8, prefill_chunk=chunk),
                    device=device)
                rng = torch.Generator().manual_seed(2)
                reqs = []
                for n in (19, 40, 57):
                    r = Request(l_in=n, l_pred=10, l_real=10)
                    r.tokens = torch.randint(2, arch.vocab, (n,),
                                             generator=rng).tolist()
                    reqs.append(r)
                    eng.submit(r)
                for _ in range(100):
                    eng.step()
                    if all(r.state == ReqState.FINISHED for r in reqs):
                        break
                if not all(r.state == ReqState.FINISHED for r in reqs):
                    raise AssertionError(f"{name} on {device}: unfinished")
                outs.append([r.tokens for r in reqs])
            if outs[0] != outs[1]:
                raise AssertionError(f"{name} chunk={chunk}: card tokens "
                                     "differ from the CPU reference")
            log(f"[reference] {name} d_model={d_model} fp32 chunk={chunk}: "
                f"card tokens == CPU tokens ({sum(map(len, outs[1]))} tokens)")


def _numel(tree) -> int:
    return sum(_numel(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


def main_path(torch, counters):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core.request import ReqState, Request
    from repro_torch.core.slo import SLO
    from repro_torch.models.model import LM
    from repro_torch.serving.cluster import ClusterConfig, ServingCluster
    from repro_torch.serving.engine import EngineConfig

    arch = get_arch("llama2-7b")
    t0 = time.perf_counter()
    params = LM(arch, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = _numel(params)
    log(f"[main] llama2-7b full width: {arch.n_layers} layers, d_model "
        f"{arch.d_model}, {arch.n_heads} heads, d_ff {arch.d_ff}, vocab "
        f"{arch.vocab}; {n_params / 1e9:.2f}B random bf16 params in "
        f"{time.perf_counter() - t0:.1f}s")
    # the engine decodes in fp32 (as the reference does), so the paper's
    # 15 ms ATGT is out of reach; this SLO lets Algorithm 1's constraints
    # bind without starving the queue
    slo = SLO(ttft=2.0, atgt=0.1)
    # one engine iteration per worker per heartbeat: the control plane
    # places each arrival against the workers' live state (a request that
    # has just emitted its first token has no ATGT slack, so constraint (d)
    # sends the next prefill elsewhere)
    cluster = ServingCluster(arch, params, slo, engine_cfg=EngineConfig(),
                             cfg=ClusterConfig(policy="aladdin",
                                               heartbeat_iters=1),
                             n_workers=2, device="cuda")
    log(f"[main] 2 workers, pool {EngineConfig().n_pages} pages x "
        f"{EngineConfig().page_size} tokens fp32 each; memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    rng = np.random.default_rng(0)
    n_req, rate = 12, 8.0          # req/s: enough load to spill past one
                                   # worker's Algorithm 1 budget
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_req))
    l_ins = rng.integers(64, 961, n_req)
    l_ins[0] = 960                              # one 1024-token bucket
    l_reals = rng.integers(16, 33, n_req)
    reqs = []
    for c in counters:
        c.launches = 0
    start = time.perf_counter()
    # a request is admitted at the first heartbeat after its arrival, one
    # per heartbeat, so each gets a prefill iteration of its own and every
    # worker that serves >= 4 requests can refit Eq. 2; TTFT counts from
    # the arrival, so the wait for the heartbeat is charged
    while len(reqs) < n_req:
        i = len(reqs)
        if time.perf_counter() - start >= arrivals[i]:
            r = Request(l_in=int(l_ins[i]), l_pred=0, l_real=int(l_reals[i]),
                        arrival=start + float(arrivals[i]))
            r.tokens = [int(x) for x in rng.integers(2, arch.vocab, r.l_in)]
            reqs.append(r)
            cluster.submit(r)
        cluster.heartbeat()
    cluster.run_until_drained(max_beats=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {c.__name__: c.launches for c in counters}

    done = [r for r in reqs if r.state == ReqState.FINISHED]
    if len(done) != n_req:
        raise AssertionError(f"only {len(done)}/{n_req} requests finished")
    for r in reqs:
        if len(r.tokens) != r.l_in + r.l_out or r.l_out != r.l_real or \
                not all(0 <= t < arch.vocab for t in r.tokens):
            raise AssertionError(f"request {r.id}: bad tokens")
    pre_t, dec_t = [], []
    for w in cluster.workers.values():
        pre_t += w.engine.traces.prefill_times
        dec_t += w.engine.traces.decode_times
    perf = cluster.perf
    if "prefill" not in perf.max_rel_err or "decode" not in perf.max_rel_err:
        raise AssertionError("TraceBuffer fit incomplete: "
                             f"{perf.max_rel_err}")
    out_tokens = sum(r.l_out for r in reqs)
    result = {
        "finished": len(done), "submitted": n_req,
        "attainment": cluster.attainment(), "slo": [slo.ttft, slo.atgt],
        "workers": len(cluster.workers),
        "placed_on": [r.worker for r in reqs],
        "wall_s": wall, "output_tokens": out_tokens,
        "output_tokens_per_s": out_tokens / wall,
        "prefill_iters": len(pre_t), "decode_iters": len(dec_t),
        "mean_prefill_ms": 1e3 * float(np.mean(pre_t)),
        "mean_decode_ms": 1e3 * float(np.mean(dec_t)),
        "ttft_s": [r.ttft() for r in reqs], "atgt_s": [r.atgt() for r in reqs],
        "eq2": {"k1": perf.prefill.k1, "c1": perf.prefill.c1},
        "eq3": {"k2": perf.decode.k2, "c2": perf.decode.c2,
                "c3": perf.decode.c3},
        "max_rel_err": perf.max_rel_err, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("[main] " + json.dumps(result))
    log(f"[main] mean decode iteration {result['mean_decode_ms']:.1f} ms; "
        f"run F (constant, an earlier run that promoted the weights every "
        f"step): {RUN_F_MS['main_mean_decode']} ms")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return launches, arch, params, cluster.w32


def _device_ms_by_kernel(torch, fn, n=3, host_keys=()):
    """Device time per call of ``fn`` by kernel name, and device operations
    (kernels and copies) per call, from torch.profiler over n calls
    (device-side events only); with ``host_keys``, a third item: the host
    ms per call of the host events whose names hold one of them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
    by_name, ops, host = {}, 0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if any(k in e.key for k in host_keys):
                host[e.key] = e.cpu_time_total / 1e3 / n
            continue
        t = e.self_device_time_total / 1e3 / n
        if t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t
            ops += e.count
    return (by_name, ops / n, host) if host_keys else (by_name, ops / n)


def _summary(profile, wall_ms):
    by_name, ops = profile
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if not busy:
        log("[breakdown] the profiler recorded no device time")
    port = {name: sum(v for k, v in by_name.items() if stem in k)
            for name, stem in PORT_KERNELS.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ops": ops, "port_kernels_ms": port,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def breakdown(torch, arch, params, w32, batch=8, prompt=512, steps=10):
    """Where an iteration's time goes, at fixed shapes on a fresh engine
    sharing the main path's weights and their fp32 copy ``w32``: prefill at each bucket (host clock
    around ``LM.prefill`` ending in a host read, cold then warm) with
    device time by kernel at the 64 and 1024 buckets, and decode at ``batch``
    sequences of ``prompt``-token contexts."""
    import numpy as np

    from repro_torch.core.request import Request
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    eng = PagedEngine(arch, params, EngineConfig(), device="cuda", w32=w32)
    rng = np.random.default_rng(1)

    def prefill(s):
        toks = torch.as_tensor(rng.integers(2, arch.vocab, (1, s)),
                               device="cuda")
        logits, _ = eng.model.prefill(params, toks)
        return int(logits.argmax())

    by_bucket = {}
    for s in (64, 128, 256, 512, 1024):
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            prefill(s)
            ms.append(1e3 * (time.perf_counter() - t0))
        by_bucket[s] = {"cold_ms": ms[0], "warm_ms": min(ms[1:])}
    profiles = {f"at_{s}": _summary(
        _device_ms_by_kernel(torch, lambda: prefill(s)),
        by_bucket[s]["warm_ms"]) for s in (64, 1024)}
    log("[breakdown] prefill " + json.dumps({"buckets": by_bucket,
                                             **profiles}))

    for _ in range(batch):
        r = Request(l_in=prompt, l_pred=0, l_real=10 ** 6)
        r.tokens = [int(x) for x in rng.integers(2, arch.vocab, prompt)]
        eng.submit(r)
    eng.step()                                  # one prefill of all
    if len(eng.running) != batch:
        raise AssertionError("breakdown: prefill did not admit the batch")
    for _ in range(3):
        eng.step()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.step()
        times.append(1e3 * (time.perf_counter() - t0))
    prof = _device_ms_by_kernel(torch, eng.step)
    dec = _summary(prof, float(np.mean(times)))
    dec.update(batch=batch, context=prompt, step_ms_min=min(times),
               step_ms=times,
               direct_copy_ms=sum(v for k, v in prof[0].items()
                                  if "direct_copy" in k))
    log("[breakdown] decode " + json.dumps(dec))
    log(f"[breakdown] decode step wall {dec['wall_ms']:.1f} ms; run F "
        f"(constant, an earlier run that promoted the weights every step): "
        f"{RUN_F_MS['breakdown_decode_wall']} ms")
    if any("direct_copy" in k for k, _ in dec["top_kernels_ms"]):
        raise AssertionError("breakdown: a copy is among the decode step's "
                             "top device operations (weights promoted per "
                             "step?)")


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


def _recent_len(cache) -> int:
    """Filled length of the staged attention caches' recent buffers (0 for
    a model without attention)."""
    for c in cache:
        if isinstance(c, dict):
            return c.get("attn", c.get("dense", c))["rec_len"]
    return 0


def generate(torch, model, params, toks, steps, s_max, step_ms=None,
             drops=None, frontend=None):
    """Greedy: ``LM.prefill`` (with a VLM's ``frontend``) then ``steps`` x
    ``LM.decode_step``, running ``LM.maybe_flush`` whenever the recent
    buffers are full. Returns the tokens (B, 1 + steps); appends each
    step's host-clock ms (ending in a sync) to ``step_ms`` when given, and
    the MoE layers' dropped assignments of the prefill and of each step
    (device scalars) to ``drops`` when given."""
    aux = drops is not None
    logits, cache, *rest = model.prefill(params, toks, s_max=s_max,
                                         return_aux=aux, frontend=frontend)
    out = [logits.argmax(-1)]
    if aux:
        drops.append(rest[0][1])
    for _ in range(steps):
        t0 = time.perf_counter()
        if _recent_len(cache) == model.recent_window:
            cache = model.maybe_flush(cache)
        logits, cache, *rest = model.decode_step(params, cache, out[-1],
                                                 return_aux=aux)
        out.append(logits.argmax(-1))
        if aux:
            drops.append(rest[0][1])
        if step_ms is not None:
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
    return torch.stack(out, dim=1)


def generation_reference_check(torch, archs, batch, prompts):
    """Reduced fp32 models (``archs``: (name, layers), d_model 256)
    generate on the card (kernels B2-B4) and on the CPU (plain versions):
    ``batch`` prompts of each length in ``prompts``, then 12 greedy decode
    steps with a recent window of 8, so maybe_flush runs. The tokens must
    be identical; for a MoE model so must the drop counts of the prefill
    and of every step, and some decode step must drop. A 45-token prompt
    is not a multiple of the reduced SSD chunk (32): the CPU takes the
    sequential oracle there, the card the ragged kernel. At batch 8 a MoE
    decode step's expert capacity is its floor of 4 for 16 assignments
    over 8 experts."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model import LM
    for name, n_layers in archs:
        arch = dataclasses.replace(
            reduced(get_arch(name), n_layers=n_layers, d_model=256,
                    vocab=512), param_dtype="float32")
        cpu = LM(arch, device="cpu", recent_window=8)
        params = cpu.init(torch.Generator().manual_seed(1))
        cuda = LM(arch, device="cuda", recent_window=8)
        params_cuda = _to_cuda(params)
        moe = any(g.kind == "moe" for g in cuda.segments)
        for s in prompts:
            toks = torch.randint(2, arch.vocab, (batch, s),
                                 generator=torch.Generator().manual_seed(s))
            drops = {"card": [], "cpu": []} if moe else {}
            want = generate(torch, cpu, params, toks, 12, s + 24,
                            drops=drops.get("cpu"))
            got = generate(torch, cuda, params_cuda, toks.cuda(), 12,
                           s + 24, drops=drops.get("card")).cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} prompt {s}: card tokens "
                                     f"{got.tolist()} != CPU {want.tolist()}")
            drops = {k: [int(d) for d in torch.stack(v).tolist()]
                     for k, v in drops.items()}
            if moe and (drops["card"] != drops["cpu"]
                        or not any(drops["cpu"][1:])):
                raise AssertionError(f"{name} prompt {s}: drops, prefill "
                                     f"then each step, card {drops['card']}"
                                     f", CPU {drops['cpu']}; some decode "
                                     "step must drop")
            log(f"[reference] {name} reduced ({n_layers} layers, d_model "
                f"256) fp32 batch {batch} prompt {s}: card tokens == CPU "
                f"tokens ({got.numel()} tokens)"
                + (f"; drops, prefill then each step, card == CPU: "
                   f"{drops['card']}" if moe else ""))


def vlm_reference_check(torch):
    """Reduced fp32 llama-3.2-vision-90b (4 layers, 2 of them
    cross-attention layers with their gates at ``VLM_GATE``; d_model 256,
    so heads of 64) generates on the card (kernels B2, B3) and on the CPU
    (plain versions) from the same 37 fp32 patch embeddings (the plain
    flash version's dense form, as at 1601): 2 prompts of 45, then 12
    greedy decode steps with a recent window of 8, so maybe_flush runs.
    The tokens must be identical; another frontend must change them."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model import LM
    n_layers, frontend_tokens = 4, 37
    arch = dataclasses.replace(
        reduced(get_arch("llama-3.2-vision-90b"), n_layers=n_layers,
                d_model=256, vocab=512),
        param_dtype="float32", n_frontend_tokens=frontend_tokens)
    cpu = LM(arch, device="cpu", recent_window=8)
    params = cpu.init(torch.Generator().manual_seed(1))
    for g in ("gate_attn", "gate_mlp"):
        params["seg0"]["cross"][g].fill_(VLM_GATE)
    cuda = LM(arch, device="cuda", recent_window=8)
    params_cuda = _to_cuda(params)
    g = torch.Generator().manual_seed(45)
    toks = torch.randint(2, arch.vocab, (2, 45), generator=g)
    fronts = [torch.randn((2, frontend_tokens, 256), generator=g)
              for _ in range(2)]
    out = []
    for fr in fronts:
        want = generate(torch, cpu, params, toks, 12, 45 + 24, frontend=fr)
        got = generate(torch, cuda, params_cuda, toks.cuda(), 12, 45 + 24,
                       frontend=fr.cuda()).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"VLM reduced: card tokens {got.tolist()}"
                                 f" != CPU {want.tolist()}")
        out.append(got)
    if torch.equal(out[0], out[1]):
        raise AssertionError("VLM reduced: another frontend gave the same "
                             "tokens")
    log(f"[reference] llama-3.2-vision-90b reduced ({n_layers} layers, "
        f"{n_layers // 2} cross, d_model 256, {frontend_tokens} frontend "
        f"tokens, gates {VLM_GATE}) fp32 batch 2 prompt 45: card tokens == "
        f"CPU tokens ({out[0].numel()} tokens) for each of 2 frontends, which "
        f"differ in {int((out[0] != out[1]).sum())} tokens")


def examples_on_card(torch):
    """The port's two example drivers (``repro_torch.examples``) run their
    ``main`` on the card; each must finish every request it submitted."""
    from repro_torch.examples import quickstart, serve_e2e
    for ex in (quickstart, serve_e2e):
        t0 = time.perf_counter()
        out = ex.main(device="cuda")
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        log(f"[examples] {ex.__name__}: " + json.dumps(out))
        if out["finished"] != out["submitted"]:
            raise AssertionError(f"{ex.__name__}: {out['finished']} of "
                                 f"{out['submitted']} requests finished")


def generation_path(torch, counters, name, runs, window, must_launch,
                    depth=None):
    """Full-width ``name`` (its depth cut to ``depth`` layers when given)
    with random bf16 weights from seed 0 generates greedily through
    ``LM.prefill`` / ``LM.decode_step`` (and ``maybe_flush`` every
    ``window`` steps) for each (batch, prompt, steps) in ``runs``; a VLM's
    cross-attention gates are set to ``VLM_GATE`` and its frontend is the
    arch's count of bf16 patch embeddings drawn from seed 0 (one draw per
    run). Counters are zeroed just before and read just after; each
    kernel in ``must_launch`` must have run, B2 once per attention layer
    (self or cross) and B4 once per Mamba layer per prefill, and B3 once
    per norm (two a layer with attention, one a Mamba layer, and the
    final one) per prefill and per decode step. For a MoE model the drops
    of the prefill and of each step are logged. Then one warm prefill and
    one decode step of the first run are profiled by kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import LM
    arch = get_arch(name)
    if depth is not None:
        arch = dataclasses.replace(arch, n_layers=depth)
    model = LM(arch, device="cuda", recent_window=window)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    vlm = any(g.kind == "vlm_super" for g in model.segments)
    if vlm:
        for g in ("gate_attn", "gate_mlp"):
            params["seg0"]["cross"][g].fill_(VLM_GATE)
    torch.cuda.synchronize()
    n_params = _numel(params)
    log(f"[{name}] full width: {arch.n_layers} layers, d_model "
        f"{arch.d_model}, vocab {arch.vocab}, segments "
        f"{[(g.kind, g.n, g.inner) for g in model.segments]}; "
        f"{n_params / 1e9:.2f}B random bf16 params in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(2, arch.vocab, (b, s)),
                               device="cuda") for b, s, _ in runs]
    fgen = torch.Generator(device="cuda").manual_seed(0)
    fronts = [torch.randn((b, arch.n_frontend_tokens, arch.d_model),
                          generator=fgen, device="cuda").to(torch.bfloat16)
              if vlm else None for b, _, _ in runs]
    is_moe = any(g.kind == "moe" for g in model.segments)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    results = []
    for (b, s, steps), toks, fr in zip(runs, prompts, fronts):
        s_max = s + steps + window
        pre_ms = []
        for _ in range(2):                                # cold, then warm
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, toks, s_max=s_max, frontend=fr)
            torch.cuda.synchronize()
            pre_ms.append(1e3 * (time.perf_counter() - t0))
        step_ms, drops = [], [] if is_moe else None
        t0 = time.perf_counter()
        out = generate(torch, model, params, toks, steps, s_max, step_ms,
                       drops, frontend=fr)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        if out.shape != (b, steps + 1) or not bool(
                ((out >= 0) & (out < arch.vocab)).all()):
            raise AssertionError(f"{name}: bad tokens {out.shape}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: non-finite prefill logits")
        results.append({
            "batch": b, "prompt": s, "decode_steps": steps,
            "prefill_cold_ms": pre_ms[0], "prefill_warm_ms": pre_ms[1],
            "decode_ms_per_step": float(np.mean(step_ms)),
            "decode_ms_min": min(step_ms),
            "output_tokens_per_s": b * steps / (sum(step_ms) / 1e3),
            "generate_s": gen_s, "distinct_tokens": int(out.unique().numel())})
        if is_moe:
            d = [int(v) for v in torch.stack(drops).tolist()]
            results[-1].update(prefill_drops=d[0],
                               decode_drops_per_step=d[1:])
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    summary = {"runs": results, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[{name}] " + json.dumps(summary))
    for k in must_launch:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    n_mamba = sum(g.n * (g.inner if g.kind == "hyb_super" else 1)
                  for g in model.segments if g.kind in ("mamba", "hyb_super"))
    n_attn = sum(g.n * (g.inner + 1 if g.kind == "vlm_super" else 1)
                 for g in model.segments if g.kind != "mamba")
    for k, per in (("ssd_scan", n_mamba), ("flash_attention", n_attn)):
        if launches[k] != 3 * len(runs) * per:
            raise AssertionError(f"{name}: {launches[k]} {k} launches, "
                                 f"not {per} per prefill over "
                                 f"{3 * len(runs)} prefills")
    norms = 1 + sum(g.n * {"mamba": 1, "hyb_super": g.inner + 2,
                           "vlm_super": 2 * (g.inner + 1)}.get(g.kind, 2)
                    for g in model.segments)
    passes = 3 * len(runs) + sum(r[2] for r in runs)
    if launches["rmsnorm"] != norms * passes:
        raise AssertionError(f"{name}: {launches['rmsnorm']} rmsnorm "
                             f"launches, not {norms} per prefill and per "
                             f"step over {passes}")

    b, s, steps = runs[0]
    toks, fr = prompts[0], fronts[0]
    s_max = s + steps + window

    def prefill():
        logits, _ = model.prefill(params, toks, s_max=s_max, frontend=fr)
        return int(logits.argmax(-1)[0])
    t0 = time.perf_counter()
    prefill()
    warm = 1e3 * (time.perf_counter() - t0)
    log(f"[{name}] prefill B={b} S={s} " + json.dumps(_summary(
        _device_ms_by_kernel(torch, prefill, n=1), warm)))
    logits, cache = model.prefill(params, toks, s_max=s_max, frontend=fr)
    tok = logits.argmax(-1)

    def step():
        logits, _ = model.decode_step(params, cache, tok)
        return int(logits.argmax(-1)[0])
    step()
    t0 = time.perf_counter()
    step()
    warm = 1e3 * (time.perf_counter() - t0)
    log(f"[{name}] decode step B={b} context {s} " + json.dumps(_summary(
        _device_ms_by_kernel(torch, step, n=3), warm)))
    if is_moe:
        moe_drop_probe(torch, name, model, params, toks, s_max)
    return launches


def moe_drop_probe(torch, name, model, params, toks, s_max):
    """Where a MoE prefill drops assignments, and whether the card drops
    the ones the CPU does, at full width. One more prefill runs with
    ``moe_ffn`` wrapped (no kernel runs inside it): a line per MoE layer
    gives its drops, the busiest expert's share of the assignments (1 /
    n_experts if routing were uniform) and how alike the tokens entering
    it are (the mean cosine of each token's FFN input to their mean). The
    input and routed weights of the layer that drops most then go through
    ``moe_ffn`` on the CPU (plain PyTorch, the path the tests hold against
    the reference): its drops beside the card's, and the largest output
    difference over the largest output. Diagnostic: nothing here fails."""
    import torch.nn.functional as F

    from repro_torch.models import model as model_mod
    arch = model.arch
    routed = model_mod.moe_ffn
    seen = []

    def probe(x, p, arch_, policy, cf=None):
        out, aux = routed(x, p, arch_, policy, cf)
        h = x.reshape(-1, x.shape[-1]).float()
        top = (h @ p["router"].float()).topk(arch.moe.top_k, dim=-1).indices
        load = torch.bincount(top.reshape(-1), minlength=arch.moe.n_experts)
        cos = F.cosine_similarity(h, h.mean(0, keepdim=True), dim=-1).mean()
        seen.append((x, p, out, torch.stack(
            [aux[1], load.max().float() / top.numel(), cos])))
        return out, aux

    t0 = time.perf_counter()
    model_mod.moe_ffn = probe
    model.prefill(params, toks, s_max=s_max)
    model_mod.moe_ffn = routed
    stats = torch.stack([r[3] for r in seen]).tolist()
    for i, (drops, share, cos) in enumerate(stats):
        log(f"[{name} drops] prefill layer {i}: drops {int(drops)} of "
            f"{toks.numel() * arch.moe.top_k}, busiest expert "
            f"{share:.4f} of assignments (uniform "
            f"{1 / arch.moe.n_experts:.4f}), mean cosine to the mean token "
            f"{cos:.4f}")
    worst = max(range(len(stats)), key=lambda i: stats[i][0])
    x, p, out, _ = seen[worst]
    p_cpu = {k: p[k].cpu() for k in ("router", "w_gate", "w_up", "w_down")}
    out_cpu, aux_cpu = routed(x.cpu(), p_cpu, arch,
                              capacity_factor=model.capacity_factor)
    err = (out.cpu().float() - out_cpu.float()).abs().max() \
        / out_cpu.float().abs().max()
    log(f"[{name} drops] layer {worst} on the CPU, from the card's input: "
        f"drops {int(aux_cpu[1])} (card {int(stats[worst][0])}); max |card "
        f"- CPU| / max |CPU| of the routed output {float(err):.3g}; "
        f"{time.perf_counter() - t0:.1f}s wall")


def _paths(tree, prefix=""):
    """(key, leaf) of nested dicts in sorted key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _fwd_bwd(torch, fn, inputs, dout):
    """fn's output on copies of ``inputs`` that require grad, and their
    gradients for ``dout``."""
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, dout)


def _retained_bwd(torch, fn, inputs, dout):
    """A call that runs the backward of one forward of ``fn`` again each
    time (its graph kept)."""
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    return lambda: torch.autograd.grad(out, xs, dout, retain_graph=True)


def training_kernel_cases(torch, F, timer, smi):
    """B2 and B3 at the training paths' shapes (granite-3-8b: B=2,
    4096-token sequences, 32/8 heads of 128; zamba2-7b's shared block: 32/32
    heads of 112; 8192 x 4096 norm rows), in bf16, forward and backward
    under autograd: each wrapper's output and gradients (the kernel's
    autograd Function: the forward kernel, then the backward kernel) held
    against the plain version's forward and its autograd gradients, then
    timed: the forward kernel, and the backward kernel
    (``flash_attention_backward`` from the forward's logsumexp,
    ``rmsnorm_backward``) as the ``flash_attention_bwd`` / ``rmsnorm_bwd``
    rows, with the closed form in PyTorch ops (``flash_attention_bwd``,
    ``rmsnorm_bwd``) as their plain column and SDPA's or ``F.rms_norm``'s
    backward beside them, each with its bound; a line of each backward
    pass's device time. The backward's bound counts the five products of
    attention's gradient (the scores recomputed) at the bf16 rate of its
    inputs, and the bytes of q, k, v, out and dout read and of dq, dk and
    dv written once; a device time under a bound raises."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_bwd,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import _launch
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_backward,
                                             rmsnorm_bwd, rmsnorm_ref)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def held(name, got, want):
        out, grads = got
        wout, wgrads = want
        errs = [check_close(torch, g, w, "bf16", f"{name} {what}")
                for what, g, w in zip(("out", "d0", "d1", "d2"),
                                      (out,) + grads, (wout,) + wgrads)]
        return errs[0], max(errs[1:])

    def under_bound(row):
        if row["device_ms"] < row["bound_ms"]:
            raise AssertionError(f"{row['kernel']} {row['case']}: device "
                                 f"time {row['device_ms']} ms under its "
                                 f"bound {row['bound_ms']} ms")

    for b, s, hq, hkv, d, tag in (TRAIN_ATTN + ("training",),
                                  TRAIN_ATTN_ZAMBA + ("zamba2 training",)):
        q, dout = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        case = f"B={b} Sq={s} Skv={s} H={hq}/{hkv} D={d} ({tag})"
        err_f, err_b = held(
            "flash " + case,
            _fwd_bwd(torch, lambda *a: flash_attention(*a, causal=True),
                     (q, k, v), dout),
            _fwd_bwd(torch, lambda *a: flash_attention_ref(*a, causal=True),
                     (q, k, v), dout))
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        out = _launch(q, k, v, True, 0, None, None, lse)
        qt, kt, vt, dt = (t.transpose(1, 2) for t in (q, k, v, dout))

        def kern_f():
            return flash_attention(q, k, v, causal=True)

        def kern_b():
            return flash_attention_backward(q, k, v, out, dout, lse,
                                            causal=True)

        def lib_f():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        pairs = s * (s + 1) / 2
        fwd_flops = 4.0 * b * pairs * hq * d
        fwd_bytes = b * (2 * s * hq * d + 2 * s * hkv * d) * 2
        record(cases, "flash_attention", case, "bf16", err_f, timer(kern_f),
               timer(lambda: flash_attention_ref(q, k, v, causal=True)),
               timer(lib_f), fwd_bytes, {"bf16": fwd_flops},
               dev=(device_ms(torch, kern_f, n=10,
                              stem=PORT_KERNELS["flash_attention"]),
                    device_ms(torch, lib_f, n=10)))
        k_ms = timer(kern_b)
        log(f"[flash_attention_bwd passes] {case}: " + json.dumps(pass_ms(
            torch, kern_b, PORT_KERNELS["flash_attention_bwd"])))
        k_dev = device_ms(torch, kern_b, n=10,
                          stem=PORT_KERNELS["flash_attention_bwd"],
                          per_call=FLASH_BWD_PASSES)
        p_ms = timer(lambda: flash_attention_bwd(q, k, v, out, dout,
                                                 causal=True, lse=lse))
        lib_b = _retained_bwd(torch, lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True), (qt, kt, vt), dt)
        record(cases, "flash_attention_bwd", case, "bf16", err_b, k_ms,
               p_ms, timer(lib_b), 2 * fwd_bytes, {"bf16": 2.5 * fwd_flops},
               dev=(k_dev, device_ms(torch, lib_b, n=5)))
        under_bound(cases[-1])
        del lib_b, out, lse, q, k, v, dout, qt, kt, vt, dt
        gc.collect()
        torch.cuda.empty_cache()

    rows, dm = TRAIN_NORM
    x, dy, w = randn(rows, dm), randn(rows, dm), randn(dm)
    case = f"{rows}x{dm} (training)"
    err_f, err_b = held(
        "rmsnorm " + case,
        _fwd_bwd(torch, lambda *a: rmsnorm(*a, eps=1e-5), (x, w), dy),
        _fwd_bwd(torch, lambda *a: rmsnorm_ref(*a, eps=1e-5), (x, w), dy))

    def norm_f():
        return rmsnorm(x, w, eps=1e-5)

    def lib_nf():
        return F.rms_norm(x, (dm,), w, 1e-5)

    def norm_b():
        return rmsnorm_backward(x, w, dy, None, 1e-5)
    n = rows * dm
    record(cases, "rmsnorm", case, "bf16", err_f, timer(norm_f),
           timer(lambda: rmsnorm_ref(x, w, None, 1e-5)), timer(lib_nf),
           (2 * n + dm) * 2, {"bf16": 4 * n},
           dev=(device_ms(torch, norm_f, stem=PORT_KERNELS["rmsnorm"]),
                device_ms(torch, lib_nf)))
    log(f"[rmsnorm_bwd passes] {case}: " + json.dumps(pass_ms(
        torch, norm_b, PORT_KERNELS["rmsnorm_bwd"])))
    lib_nb = _retained_bwd(
        torch, lambda *a: F.rms_norm(a[0], (dm,), a[1], 1e-5), (x, w), dy)
    record(cases, "rmsnorm_bwd", case, "bf16", err_b, timer(norm_b),
           timer(lambda: rmsnorm_bwd(x, w, dy, None, 1e-5)), timer(lib_nb),
           (3 * n + 2 * dm) * 2, {"bf16": 8 * n},
           dev=(device_ms(torch, norm_b, stem=PORT_KERNELS["rmsnorm_bwd"],
                          per_call=RMSNORM_BWD_PASSES),
                device_ms(torch, lib_nb)))
    under_bound(cases[-1])
    del lib_nb
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train kernels] card {smi}")
    return cases


def training_reference_check(torch):
    """Reduced fp32 granite-3-8b (GQA 4/2, tied embeddings), llama2-7b
    (heads of 64 and 128, which B2 takes), mamba2-1.3b (4 Mamba layers;
    SSD heads of 16, a state of 16, chunks of 32) and zamba2-7b (5 layers:
    3 Mamba layers and 2 sites of the shared attention block), from the
    same params and batches on the card (kernels B2, B3 and B4 under
    autograd, each backward a kernel too) and on the CPU (plain versions):
    every leaf's gradient on the card exists and is
    finite and agrees with the CPU's within 1e-4 of the leaf's largest
    value, the losses of 3 train steps (2 microbatches, AdamW, lr 1e-3)
    agree within 1e-4 relative, and every parameter after them within
    1e-4 relative plus 0.05 lr absolute: AdamW divides each element's
    first moment by the root of its second, so an element whose gradient
    is near 0 turns the gradients' fp32 noise into an update difference of
    up to lr (the tolerance of the CPU tests against JAX's steps).

    The two SSM archs' gradients carry more fp32 noise than the dense
    archs' (the decay's gradient is a difference of the masked scores' row
    and column sums; the worst leaf, A_log, ~4e-5 of its largest against
    ~1e-6), and AdamW's eps of 1e-8 turns an element's gradient of ~1e-8,
    some 1e-7 of its leaf's largest, into an update of any size up to lr:
    two correct fp32 versions of the SSD's gradient part there by more
    than 0.05 lr. So for them each of the 3 steps is held in its two
    parts from the CPU's state before it: the card's gradients, on the
    CPU's params and that step's batch, within 1e-4 of each leaf's
    largest, and AdamW on the card, on the CPU's gradients, state and
    params, within 1e-4 relative plus 0.05 lr of the CPU's; the losses of
    the 3 card steps as above, and the parameters after them are logged
    (the count of elements outside 1e-4 relative plus 0.05 lr, the worst
    difference), not gated."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model import LM
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      batch_at_step, make_train_step)
    from repro_torch.training.optimizer import (OptState, apply_adamw,
                                                init_opt_state, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_step import loss_and_grads
    tol, lr = 1e-4, 1e-3
    for name, n_layers, d_model in (
            ("granite-3-8b", 2, 256), ("llama2-7b", 2, 512),
            ("mamba2-1.3b", 4, 256), ("zamba2-7b", 5, 256)):
        arch = dataclasses.replace(
            reduced(get_arch(name), n_layers=n_layers, d_model=d_model,
                    vocab=512), param_dtype="float32")
        cpu_params = LM(arch, device="cpu").init(
            torch.Generator().manual_seed(1))
        dcfg = DataConfig(vocab=arch.vocab, seq_len=128, global_batch=4)
        tcfg = TrainConfig(adamw=AdamWConfig(lr=lr, warmup_steps=1,
                                             total_steps=3),
                           microbatches=2)
        runs = []
        for dev in ("cpu", "cuda"):
            model = LM(arch, device=dev, loss_chunk=64)
            params = tree_map(lambda t: t.to(dev), cpu_params)
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, _ = model.train_loss(p, batch_at_step(dcfg, 0, dev))
            grads = torch.autograd.grad(loss, tree_leaves(p),
                                        allow_unused=True)
            opt = init_opt_state(params)
            step = make_train_step(model, tcfg)
            losses, states = [], []
            for i in range(3):
                states.append((params, opt))
                params, opt, m = step(params, opt,
                                      batch_at_step(dcfg, i, dev))
                losses.append(float(m["loss"]))
            runs.append((grads, losses, tree_leaves(params), states))
        cpu, card = runs
        keys = [k for k, _ in _paths(cpu_params)]
        bad = [k for k, g in zip(keys, card[0])
               if g is None or not bool(torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"{name}: no or non-finite card gradient "
                                 f"for {bad}")

        def rel(a, b):
            return float((a.cpu() - b).abs().max()
                         / b.abs().max().clamp_min(1e-30))

        def outside(a, b):
            """|a - b| less rtol 1e-4 and 0.05 lr (<= 0: within)."""
            return (a.cpu() - b).abs() - tol * b.abs() - 0.05 * lr
        g_err = max(zip(map(rel, card[0], cpu[0]), keys))
        p_err = max(zip(map(rel, card[2], cpu[2]), keys))
        p_abs = max(zip((float((a.cpu() - b).abs().max())
                         for a, b in zip(card[2], cpu[2])), keys))
        p_out = max(float(outside(a, b).max())
                    for a, b in zip(card[2], cpu[2]))
        l_err = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
        line = (f"[train reference] {name} {n_layers} layers d_model="
                f"{d_model} fp32, 3 steps: losses card {card[1]} CPU "
                f"{cpu[1]} (worst relative {l_err:.3g}); every leaf's card "
                f"gradient finite, worst {g_err[0]:.3g} of its largest "
                f"({g_err[1]}); params after the steps worst {p_err[0]:.3g}"
                f" of the leaf's largest ({p_err[1]}), worst absolute "
                f"{p_abs[0]:.3g} = {p_abs[0] / lr:.3g} lr ({p_abs[1]})")
        if arch.ssm is not None:
            n_out = sum(int((outside(a, b) > 0).sum())
                        for a, b in zip(card[2], cpu[2]))
            s_err, o_out = (0.0, ""), -1.0
            for i, (p_i, o_i) in enumerate(cpu[3]):
                grads, new = {}, {}
                for dev in ("cpu", "cuda"):
                    def mv(t, dev=dev):
                        return t.to(dev)
                    _, grads[dev], _ = loss_and_grads(
                        LM(arch, device=dev, loss_chunk=64),
                        tree_map(mv, p_i), batch_at_step(dcfg, i, dev),
                        tcfg.microbatches)
                    state = OptState(step=mv(o_i.step),
                                     mu=tree_map(mv, o_i.mu),
                                     nu=tree_map(mv, o_i.nu),
                                     master=tree_map(mv, o_i.master))
                    new[dev] = tree_leaves(apply_adamw(
                        tcfg.adamw, tree_map(mv, grads["cpu"]), state,
                        tree_map(mv, p_i))[0])
                s_err = max(s_err, max(zip(
                    map(rel, tree_leaves(grads["cuda"]),
                        tree_leaves(grads["cpu"])),
                    (f"step {i} {k}" for k in keys))))
                o_out = max([o_out] + [float(outside(a, b).max())
                                       for a, b in zip(new["cuda"],
                                                       new["cpu"])])
            line += (f"; {n_out} elements outside 1e-4 relative plus 0.05 "
                     f"lr (not gated); from the CPU's state before each "
                     f"step: card gradients worst {s_err[0]:.3g} of the "
                     f"leaf's largest ({s_err[1]}), AdamW on the CPU's "
                     f"gradients worst excess {o_out:.3g}")
            g_err, p_out = max(g_err, s_err), o_out
        log(line)
        if max(l_err, g_err[0]) > tol or p_out > 0:
            raise AssertionError(f"{name}: card training differs from the "
                                 "CPU's beyond the tolerances above")


def _layer_counts(model):
    """(Mamba layers, attention layers) of ``model``'s segments; a hybrid
    super-block's shared attention block counts once per site."""
    mamba = attn = 0
    for g in model.segments:
        if g.kind == "mamba":
            mamba += g.n
        elif g.kind == "hyb_super":
            mamba += g.n * g.inner
            attn += g.n
        else:
            attn += g.n
    return mamba, attn


def training_path(torch, counters, smi, name, layers, steps, remat):
    """``name`` at full width cut to ``layers`` layers (``TRAIN_PATHS``),
    random bf16 weights from seed 0, trained with AdamW (lr 3e-4, 1 warmup
    step) on sequences of 4096, a global batch of 4 as 2 microbatches of 2,
    each layer body under activation checkpointing with ``remat``: one warm
    step, then ``steps`` timed steps on ``batch_at_step`` steps 0 and 1 in
    turn. Counters are zeroed just before the timed steps and read after
    the first and after the last: per microbatch, B2 must launch once per
    attention layer (a hybrid's shared block once per site), B3 once per
    norm (two an attention layer, one a Mamba layer, and the final one),
    B4's forward once per Mamba layer, each layer body's kernels twice
    under remat (its forward again in the backward), and the backward
    kernels once per layer each: B2's once per attention layer, B3's once
    per norm, B4's once per Mamba layer; nothing else. Logs step ms, tokens/s,
    losses and grad norms (finite, as a gate), peak memory, model FLOPs per
    step (6 per parameter and token, plus attention's) over step time over
    the card's bf16 peak, and from a profiled step the device time by
    kernel, the idle share and each phase's share (``train_step.forward``
    / ``backward`` / ``optimizer`` ranges: a kernel counts for the range
    its launching op started in). Returns the counts of the timed steps."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import LM
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      batch_at_step, make_train_step)
    from repro_torch.training.optimizer import init_opt_state
    full = get_arch(name)
    arch = dataclasses.replace(full, n_layers=layers)
    model = LM(arch, device="cuda", loss_chunk=512, remat=remat)
    mamba, attn = _layer_counts(model)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    n_params = _numel(params)
    mb, micro, seq = TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ
    tokens = mb * seq
    log(f"[train {name}] full width, {arch.n_layers} of {full.n_layers} "
        f"layers ({mamba} Mamba, {attn} attention), remat {remat}: d_model "
        f"{arch.d_model}, vocab {arch.vocab}, segments "
        f"{[(g.kind, g.n, g.inner) for g in model.segments]}; "
        f"{n_params / 1e9:.3f}B random bf16 params and fp32 AdamW state in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=1,
                                         total_steps=steps + 1),
                       microbatches=micro)
    dcfg = DataConfig(vocab=arch.vocab, seq_len=seq, global_batch=mb)
    batches = [batch_at_step(dcfg, i, "cuda") for i in (0, 1)]
    step = make_train_step(model, tcfg)
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batches[0])
    first = float(m["loss"])
    warm_s = time.perf_counter() - t0

    for c in counters:
        c.launches = 0
    step_ms, losses, gnorms, per_step = [], [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i % 2])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if per_step is None:
            per_step = {c.__name__: c.launches for c in counters}
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    body = 2 if remat else 1
    want = {c.__name__: 0 for c in counters}
    want.update(flash_attention=micro * body * attn,
                rmsnorm=micro * (body * (mamba + 2 * attn) + 1),
                ssd_scan=micro * body * mamba,
                ssd_scan_backward=micro * mamba,
                flash_attention_backward=micro * attn,
                rmsnorm_backward=micro * (mamba + 2 * attn + 1))
    want = {k: v for k, v in want.items() if k in launches}
    if per_step != want or launches != {k: steps * v
                                        for k, v in want.items()}:
        raise AssertionError(f"{name} training launches: {per_step} in a "
                             f"step, {launches} in {steps}; want {want} a "
                             "step")
    if not all(math.isfinite(x) for x in losses + gnorms + [first]):
        raise AssertionError(f"{name} training: non-finite loss or grad "
                             f"norm {losses} {gnorms}")
    pairs = seq * (seq + 1) / 2
    flops = 6.0 * n_params * tokens + 12.0 * attn * mb * pairs \
        * arch.n_heads * arch.resolved_head_dim
    mean_ms = float(np.mean(step_ms))
    result = {
        "arch": name, "layers": arch.n_layers, "mamba_layers": mamba,
        "attention_layers": attn, "remat": remat, "params": n_params,
        "seq": seq, "global_batch": mb, "microbatches": micro,
        "warm_step_s": warm_s, "step_ms": step_ms, "mean_step_ms": mean_ms,
        "tokens_per_s": tokens / (mean_ms / 1e3), "first_loss": first,
        "losses": losses, "grad_norms": gnorms,
        "model_flops_per_step": flops,
        "mfu_bf16_peak": flops / (mean_ms / 1e3) / PEAK_FLOPS["bf16"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": per_step, "launches": launches}
    log(f"[train {name}] " + json.dumps(result))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step(params, opt, batches[0])
        float(out[2]["loss"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    del out
    events = prof.events()
    ranges = [(e.name.split(".")[1], e.time_range.start, e.time_range.end)
              for e in events if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("train_step.")]
    phase = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0, "none": 0.0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        t = e.time_range.start
        where = next((n for n, a, b in ranges if a <= t <= b), "none")
        phase[where] += sum(k.duration for k in e.kernels) / 1e3
    by_name, n_ops = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.key.startswith("train_step.") \
                and e.self_device_time_total > 0:
            by_name[e.key] = e.self_device_time_total / 1e3
            n_ops += e.count
    summary = _summary((by_name, n_ops), wall)
    busy = sum(phase.values())
    summary["phase_device_ms"] = phase
    summary["phase_share"] = {k: v / busy for k, v in phase.items()} \
        if busy else None
    log(f"[train {name}] profiled step " + json.dumps(summary))
    log(f"[train {name}] mean step {mean_ms:.1f} ms, "
        f"{result['tokens_per_s']:.0f} tokens/s, model FLOPs "
        f"{flops / 1e12:.1f} T a step = {result['mfu_bf16_peak']:.3f} of "
        f"the bf16 peak, peak memory {result['peak_mem_gb']:.1f} GB; card "
        f"{smi}")
    del params, opt, batches, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_example_on_card(torch):
    """The port's training example (``repro_torch.examples.
    train_example``) with the reference's counts on the card: 200 steps,
    every loss finite, the mean loss of the last 25 steps below that of the
    first 25; then, its step-200 checkpoint removed, a restart resumes at
    step 100 and runs the other 100."""
    import shutil
    import tempfile

    from repro_torch.examples import train_example
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out = train_example.main(device="cuda", steps=200, ckpt=d)
        wall = time.perf_counter() - t0
        losses = out["losses"]
        first, last = float(sum(losses[:25]) / 25), \
            float(sum(losses[-25:]) / 25)
        if len(losses) != 200 or not all(map(math.isfinite, losses)) \
                or not last < first:
            raise AssertionError(f"train_example: {len(losses)} steps, "
                                 f"first 25 mean {first}, last 25 {last}")
        shutil.rmtree(f"{d}/step_00000200")
        t0 = time.perf_counter()
        again = train_example.main(device="cuda", steps=200, ckpt=d)
        if again["start"] != 100 or len(again["losses"]) != 100:
            raise AssertionError(f"train_example resumed at "
                                 f"{again['start']}, ran "
                                 f"{len(again['losses'])} steps")
        diff = max(abs(a - b) for a, b in zip(again["losses"],
                                              losses[100:]))
    log("[examples] train_example: " + json.dumps({
        "steps": 200, "params": out["params"], "wall_s": wall,
        "ms_per_step": 1e3 * wall / 200, "first_25_mean": first,
        "last_25_mean": last, "loss_200": losses[-1],
        "resume_wall_s": time.perf_counter() - t0,
        "resumed_max_loss_diff": diff}))


# ---- the Scenario API's compiled simulation core ----------------------------
#
# The reference's `scale` scenario (benchmarks/bench_cluster_sim.py), built
# here from the port's copies: llama2-70b on 4 A100s per worker at the
# paper's SLO, max batch 32, inert KV, a diurnal trace at 11.574 req/s
# (amplitude 0.6, seed 5); the one-tenth slice (864 s at a 0.25 s
# heartbeat) is held request by request against the numpy core and sized by
# optimize(); the full day (8640 s at 0.02 s) runs on the card alone.
SCALE_RATE, SCALE_SEED, SCALE_WORKERS = 11.574, 5, 24
SCALE_SLICE = (864.0, 0.25)
SCALE_DAY = (8640.0, 0.02)
SCALE_OPT = dict(lo=16, hi=40, attain_target=0.98)
FASTSIM_REL = 1e-12          # per-request floats; integers exact
REPORT_REL = 1e-9            # report floats (finish-order means)


def _scale_scenario(api, spec, slo, wl, duration, hb, n, engine):
    cfg = wl.WorkloadConfig(mean_rate=SCALE_RATE, duration=duration,
                            seed=SCALE_SEED, in_mu=5.0, in_sigma=1.1,
                            out_mu=5.3, out_sigma=0.9)
    return api.Scenario(
        workload=lambda: wl.diurnal_trace(cfg, amplitude=0.6,
                                          period=duration),
        fleet=api.FleetSpec([api.PoolSpec(spec, n)]), slo=slo,
        topology=api.Colocated(heartbeat=hb), scaling=api.FixedScale(),
        engine=engine)


def _kernel_inputs(api, fj, sc, device, n_active=None):
    """The whole-trace kernel's inputs for a scenario, as its host side
    builds them; ``n_active`` defaults to the whole fleet."""
    sc = api.resolve_scenario(sc)
    specs = fj.check_jax_envelope(sc)
    ordered, arrival, l_in, l_real = fj._trace_arrays(sc.materialize())
    multi = sc.tenants is not None and len(sc.tenants) > 1
    return fj._kernel_inputs(
        sc, specs, ordered, arrival, l_in, l_real,
        len(specs) if n_active is None else n_active, device, edf=multi)


def _held_outputs(torch, got, want, what: str):
    """The kernel's outputs against the plain version's: integers equal,
    floats within FASTSIM_REL, NaN where NaN. Returns the largest
    relative and absolute differences of the floats."""
    rel = err = 0.0
    for name, g, w in zip(("l_out", "t_decode_spent", "t_first_token",
                           "t_finish", "beats"), got, want):
        g = g.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"[fastsim] {what}: {name} {g.shape} "
                                 f"{g.dtype} != {w.shape} {w.dtype}")
        if w.dtype == torch.int64:
            if not torch.equal(g, w):
                raise AssertionError(f"[fastsim] {what}: {name} differs")
            continue
        if not torch.equal(g.isnan(), w.isnan()):
            raise AssertionError(f"[fastsim] {what}: {name} NaNs differ")
        ok = ~w.isnan()
        d = (g[ok] - w[ok]).abs()
        if d.numel():
            err = max(err, float(d.max()))
            rel = max(rel, float((d / w[ok].abs().clamp_min(1e-300)).max()))
    if rel > FASTSIM_REL:
        raise AssertionError(f"[fastsim] {what}: relative difference {rel} "
                             f"over {FASTSIM_REL}")
    return rel, err


def _held_requests(want, got, what: str) -> float:
    """Two engines' outcomes request by request (traces of one
    materialization): integers equal, times within FASTSIM_REL. Returns
    the largest relative difference."""
    rel = 0.0
    key = lambda r: (r.arrival, r.id)  # noqa: E731
    if len(want) != len(got):
        raise AssertionError(f"[fastsim] {what}: {len(got)} requests, "
                             f"want {len(want)}")
    for a, b in zip(sorted(want, key=key), sorted(got, key=key)):
        if a.l_out != b.l_out or (a.t_finish is None) != (b.t_finish is None) \
                or (a.t_first_token is None) != (b.t_first_token is None):
            raise AssertionError(f"[fastsim] {what}: request {a.id} differs")
        for x, y in ((a.t_first_token, b.t_first_token),
                     (a.t_finish, b.t_finish),
                     (a.t_decode_spent, b.t_decode_spent)):
            if x is not None and x != y:
                rel = max(rel, abs(x - y) / max(abs(x), 1e-300))
    if rel > FASTSIM_REL:
        raise AssertionError(f"[fastsim] {what}: relative difference {rel} "
                             f"over {FASTSIM_REL}")
    return rel


def _held_rows(want: dict, got: dict, what: str) -> None:
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            if math.isnan(w) != math.isnan(g) or (
                    not math.isnan(w) and abs(g - w) > REPORT_REL * abs(w)
                    + 1e-12):
                raise AssertionError(f"[fastsim] {what}: {k} {g} != {w}")
        elif w != g:
            raise AssertionError(f"[fastsim] {what}: {k} {g} != {w}")


class LaunchTimes:
    """Times every launch of the whole-trace kernel that its host side
    (``serving/fastsim_jax.py``) makes while the context is open: CUDA
    events around each ``whole_trace`` call, read at once (the host side
    reads the outputs right after the call anyway). ``ms`` lists them,
    ``candidates`` the fleet sizes each launch simulated."""

    def __init__(self, torch, fj):
        self.torch, self.fj, self.ms, self.candidates = torch, fj, [], []
        self.nbytes = []

    def __enter__(self):
        torch, inner = self.torch, self.fj.whole_trace

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kw)
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
            self.candidates.append(args[3].reshape(-1).tolist())
            # the bytes a launch must move, as the slice's bound counts
            # them: the trace (six values a request) and the fleet's eight
            # parameters a worker read once, the four outputs a request
            # written once for each candidate
            n, C = int(args[0].shape[0]), len(self.candidates[-1])
            self.nbytes.append(8 * (6 * n + 1 + 8 * len(kw["maxb"]))
                               + C * 8 * (4 * n + 1))
            return out

        self.inner, self.fj.whole_trace = inner, timed
        return self

    def __exit__(self, *exc):
        self.fj.whole_trace = self.inner


def fastsim_phase(torch, smi):
    """(a) the small traces of the CPU twins through the kernel, held
    against the plain version and the numpy core; (b) the `scale` slice,
    kernel against plain version and ``engine="jax"`` against
    ``engine="vectorized"``; (c) optimize() on the slice on both engines;
    (d) the full day on the card. Returns the kernels-line case (the
    slice) and the launches of (c) and (d)."""
    import dataclasses

    from repro_torch.core.perf_model import (DecodeModel, KVModel,
                                             PerfModel, PrefillModel)
    from repro_torch.core.request import Request
    from repro_torch.core.slo import SLO
    from repro_torch.core.worker_config import WorkerSpec
    from repro_torch.kernels.fastsim import whole_trace
    from repro_torch.serving import api
    from repro_torch.serving import fastsim_jax as fj
    from repro_torch.serving import workload as wl
    from repro_torch.serving.fastsim import run_colocated_vectorized
    from repro_torch.serving.tenants import materialize_tenants

    cuda = torch.device("cuda")
    spec, slo = scale_spec()
    grid_spec = WorkerSpec(
        perf=PerfModel(kv=KVModel(h=0.0, j=0.0),
                       prefill=PrefillModel(k1=2.2e-5, c1=8e-3),
                       decode=DecodeModel(k2=6e-6, c2=3.5e-4, c3=9e-3)),
        kv_capacity=1e18, max_batch=24, n_accelerators=2, name="eq-jax")

    def small(trace, n, policy, s=SLO(2.0, 0.2), tenants=None):
        return api.Scenario(
            workload=trace, fleet=api.FleetSpec([api.PoolSpec(grid_spec,
                                                              n)]),
            slo=s, tenants=tenants, topology=api.Colocated(policy=policy),
            scaling=api.FixedScale(), engine="jax")

    grid = wl.generate_trace(wl.WorkloadConfig(
        mean_rate=3.0, duration=20.0, seed=11, tail_frac=0.3, in_mu=4.6,
        out_mu=4.4, out_sigma=1.0))
    tenants = [
        api.TenantSpec(name="chat", workload=lambda: wl.generate_trace(
            wl.WorkloadConfig(mean_rate=4.0, duration=20.0, seed=17,
                              tail_frac=0.2, in_mu=4.6, out_mu=4.2,
                              out_sigma=1.0)),
            slo=SLO(ttft=0.6, atgt=0.060), priority=1, tier="interactive"),
        api.TenantSpec(name="eval", workload=lambda: wl.generate_trace(
            wl.WorkloadConfig(mean_rate=4.0, duration=20.0, seed=23,
                              tail_frac=0.3, in_mu=5.0, out_mu=4.8,
                              out_sigma=1.1)),
            slo=SLO(ttft=5.0, atgt=0.200), priority=0, tier="batch")]
    merged = materialize_tenants(tenants)
    lone = [Request(l_in=96, l_pred=0, l_real=40, arrival=0.4)]
    big = WorkerSpec(
        perf=PerfModel(kv=KVModel(h=0.0, j=0.0),
                       prefill=PrefillModel(k1=1.1e-5, c1=5e-3),
                       decode=DecodeModel(k2=3e-6, c2=2.0e-4, c3=6e-3)),
        kv_capacity=1e18, max_batch=32, n_accelerators=4)
    mixed = dataclasses.replace(
        small(wl.generate_trace(wl.WorkloadConfig(
            mean_rate=4.0, duration=25.0, seed=2, tail_frac=0.25,
            in_mu=5.0, out_mu=4.8, out_sigma=1.1)), 1, "aladdin"),
        fleet=api.FleetSpec([api.PoolSpec(grid_spec, 1),
                             api.PoolSpec(big, 2)]),
        topology=api.Colocated(heartbeat=0.1, theta=0.8, gamma=0.25))
    cases = {"heterogeneous fleet": mixed,
             "grid aladdin": small(grid, 2, "aladdin"),
             "grid jsq": small(grid, 2, "jsq"),
             "lone arrival": small(lone, 2, "aladdin"),
             "two tenants, EDF backlog, aladdin":
                 small(merged, 1, "aladdin", tenants=tenants),
             "two tenants, EDF backlog, jsq":
                 small(merged, 1, "jsq", tenants=tenants)}
    rel = err = 0.0
    t0 = time.perf_counter()
    for what, sc in cases.items():
        args, st = _kernel_inputs(api, fj, sc, "cpu")
        want = whole_trace(*args, **st)
        got = whole_trace(*(a.to(cuda) for a in args), **st)
        r, e = _held_outputs(torch, got, want, what)
        rel, err = max(rel, r), max(err, e)
        jx_t, vec_t = wl.clone_trace(sc.workload), wl.clone_trace(
            sc.workload)
        jx = fj.run_colocated_jax(dataclasses.replace(sc, workload=jx_t))
        vec = run_colocated_vectorized(dataclasses.replace(
            sc, workload=vec_t, engine="vectorized"))
        rel = max(rel, _held_requests(vec_t, jx_t, what))
        _held_rows(vec.row(), jx.row(), what)
        if jx.beats != vec.beats:
            raise AssertionError(f"[fastsim] {what}: beats {jx.beats} != "
                                 f"{vec.beats}")
        log(f"[fastsim small] {what}: {len(jx_t)} requests, finished "
            f"{jx.finished}, beats {jx.beats}, attainment {jx.attainment}")
    bracket = wl.generate_trace(wl.WorkloadConfig(mean_rate=6.0,
                                                  duration=15.0, seed=5))
    scs = [small(wl.clone_trace(bracket), n, "aladdin", s=SLO(1.0, 0.1))
           for n in (2, 4, 6)]
    args, st = _kernel_inputs(api, fj, scs[-1], "cpu", [2, 4, 6])
    r, e = _held_outputs(torch, whole_trace(*(a.to(cuda) for a in args),
                                            **st),
                         whole_trace(*args, **st), "bracket 2/4/6")
    rel, err = max(rel, r), max(err, e)
    for sc, rep in zip(scs, fj.run_candidate_batch(scs)):
        vec = run_colocated_vectorized(dataclasses.replace(
            sc, workload=wl.clone_trace(bracket), engine="vectorized"))
        _held_rows(vec.row(), rep.row(), f"bracket {rep.peak_workers}")
    log(f"[fastsim small] six scenarios and a 3-candidate bracket held: "
        f"largest relative difference {rel}, absolute {err}; "
        f"{time.perf_counter() - t0:.1f}s wall")

    # (b) the scale slice
    dur, hb = SCALE_SLICE
    sc_j = _scale_scenario(api, spec, slo, wl, dur, hb, SCALE_WORKERS, "jax")
    args, st = _kernel_inputs(api, fj, sc_j, "cpu")
    n = int(args[0].shape[0])
    t0 = time.perf_counter()
    want = whole_trace(*args, **st)
    plain_ms = (time.perf_counter() - t0) * 1e3
    dev_args = [a.to(cuda) for a in args]
    whole_trace(*dev_args, **st)                    # warm: module import
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    got = whole_trace(*dev_args, **st)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    kern_ms = start.elapsed_time(end)
    r, e = _held_outputs(torch, got, want, "scale slice")
    rel, err = max(rel, r), max(err, e)
    l_out = int(want[0].sum())
    B = max(st["maxb"])
    nbytes = n * 6 * 8 + 8 + 8 * 8 * SCALE_WORKERS + n * 4 * 8 + 8
    # operations: at least the 4 fp64 operations of one decode iteration
    # for every max-batch of generated tokens
    slice_case = {
        "kernel": "fastsim_whole_trace", "case": f"scale slice {n} requests "
        f"{SCALE_WORKERS} workers hb {hb}", "dtype": "fp64",
        "max_abs_err": err, "kernel_ms": kern_ms, "device_ms": kern_ms,
        "plain_ms": plain_ms, "library_ms": None}
    b_ms, b_by = bound(nbytes, {"fp64": 4.0 * l_out / B})
    slice_case.update(bound_ms=b_ms, bound_by=b_by)
    log(json.dumps(slice_case))
    # the trace is generated before each run and timed apart: the run's
    # wall is the engine's alone
    t0 = time.perf_counter()
    jx_t = sc_j.materialize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jx = api.run(dataclasses.replace(sc_j, workload=jx_t))
    jax_wall = time.perf_counter() - t0
    vec_t = sc_j.materialize()
    t0 = time.perf_counter()
    vec = api.run(dataclasses.replace(sc_j, workload=vec_t,
                                      engine="vectorized"))
    vec_wall = time.perf_counter() - t0
    rel = max(rel, _held_requests(vec_t, jx_t, "scale slice"))
    _held_rows(vec.row(), jx.row(), "scale slice")
    if jx.beats != vec.beats:
        raise AssertionError(f"[fastsim] scale slice: beats {jx.beats} != "
                             f"{vec.beats}")
    log("[fastsim slice] " + json.dumps({
        "requests": n, "workers": SCALE_WORKERS, "heartbeat": hb,
        "finished": jx.finished, "total": jx.total,
        "attainment": jx.attainment, "p99_ttft": jx.p99_ttft,
        "beats": jx.beats, "kernel_device_ms": kern_ms,
        "kernel_host_ms": host_ms, "plain_ms": plain_ms,
        "trace_generation_s": gen_s,
        "jax_run_wall_s": jax_wall, "vectorized_run_wall_s": vec_wall,
        "largest_rel_diff": rel, "card": smi}))

    # (c) optimize() on the slice, both engines; (d) the day on the card.
    # The launch counter is zeroed just before and read just after.
    whole_trace.launches = 0
    plans = {}
    for engine in ("jax", "vectorized"):
        sc = _scale_scenario(api, spec, slo, wl, dur, hb, SCALE_WORKERS,
                             engine)
        t0 = time.perf_counter()
        with LaunchTimes(torch, fj) as times:
            plan = api.optimize(sc, **SCALE_OPT)
        per_launch = times.ms if engine == "jax" else None
        fleets = times.candidates if engine == "jax" else None
        bounds = [b / HBM_BYTES_PER_S * 1e3 for b in times.nbytes] \
            if engine == "jax" else None
        plans[engine] = plan
        log("[fastsim optimize] " + json.dumps({
            "engine": engine, "n_workers": plan.n_workers,
            "attainment": plan.report.attainment, "evals": plan.evals,
            "wall_s": time.perf_counter() - t0,
            "kernel_device_ms_per_launch": per_launch,
            "bound_ms_per_launch": bounds,
            "fleet_sizes_per_launch": fleets}))
    jp, vp = plans["jax"], plans["vectorized"]
    if (jp.n_workers, jp.report.attainment) \
            != (vp.n_workers, vp.report.attainment):
        raise AssertionError(f"[fastsim] optimize: jax {jp.n_workers} "
                             f"workers at {jp.report.attainment}, "
                             f"vectorized {vp.n_workers} at "
                             f"{vp.report.attainment}")
    dur, hb = SCALE_DAY
    sc = _scale_scenario(api, spec, slo, wl, dur, hb, SCALE_WORKERS, "jax")
    t0 = time.perf_counter()
    trace = sc.materialize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with LaunchTimes(torch, fj) as times:
        day = api.run(dataclasses.replace(sc, workload=trace))
    wall = time.perf_counter() - t0
    dev = times.ms
    if not (day.finished > 0 and math.isfinite(day.p99_ttft)
            and 0.0 < day.attainment <= 1.0 and len(dev) == 1):
        raise AssertionError(f"[fastsim] full day: {day.row()}, kernel "
                             f"launches seen {dev}")
    launches = whole_trace.launches
    log("[fastsim day] " + json.dumps({
        "requests": day.total, "finished": day.finished,
        "workers": SCALE_WORKERS, "heartbeat": hb,
        "attainment": day.attainment, "p99_ttft": day.p99_ttft,
        "beats": day.beats, "trace_generation_s": gen_s,
        "run_wall_ms": wall * 1e3, "device_ms": dev[0],
        "host_ms": wall * 1e3 - dev[0],
        "beats_per_s_wall": day.beats / wall,
        "beats_per_s_device": day.beats / (dev[0] / 1e3),
        "launches_optimize_and_day": launches, "card": smi}))
    if launches < 2:
        raise AssertionError(f"[fastsim] the kernel ran {launches} times on "
                             "the main path")
    # the kernel's split, with its counters on, after the main path's count
    # was read: the slice, optimize's 40-worker launch and the day
    for what, (case_sc, reps) in whole_split_cases(
            api, wl, spec, slo, day=dataclasses.replace(
                sc, workload=trace)).items():
        args, st = _kernel_inputs(api, fj, case_sc, cuda)
        split = whole_split(torch, args, st, reps, smi)
        log(f"[fastsim whole split] {what}, before the redesign "
            "(recorded): " + json.dumps(WHOLE_SPLIT_BEFORE.get(what)))
        log(f"[fastsim whole split] {what}: " + json.dumps(split))
    return slice_case, launches


def scale_spec():
    """The `scale` scenario's worker and SLO: llama2-70b on 4 A100s, max
    batch 32, inert KV, the paper's SLO."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.perf_model import PerfModel
    from repro_torch.core.slo import PAPER_SLOS
    from repro_torch.core.worker_config import A100_80G, make_worker_spec
    slo = PAPER_SLOS["llama2-70b"]
    base = make_worker_spec(get_arch("llama2-70b"), A100_80G, slo, n_g=4)
    return dataclasses.replace(base, max_batch=32, perf=PerfModel(
        prefill=base.perf.prefill, decode=base.perf.decode)), slo


def whole_split_cases(api, wl, spec, slo, day=None) -> dict:
    """The whole-trace kernel's split cases, each a scenario and the
    launches to count: the `scale` slice, optimize's 40-worker launch on
    it, and the day (``day``, or made here)."""
    if day is None:
        day = _scale_scenario(api, spec, slo, wl, *SCALE_DAY, SCALE_WORKERS,
                              "jax")
    return {
        "slice": (_scale_scenario(api, spec, slo, wl, *SCALE_SLICE,
                                  SCALE_WORKERS, "jax"), 10),
        "optimize 40 workers": (_scale_scenario(
            api, spec, slo, wl, *SCALE_SLICE, SCALE_OPT["hi"], "jax"), 10),
        "day": (day, 1)}


# the whole-trace kernel's phases (``WHOLE_STATS``' cycle counters, in the
# order printed)
WHOLE_PHASES = ("admit", "try", "commit", "advance", "aggregate", "barrier")
# the split of the whole-trace kernel before its redesign (the kernel of
# commit cc6f3cf with the counters added and nothing else changed), measured
# by ``whole_split`` on an NVIDIA H100 80GB HBM3 at 700 W, SM clock 1980
# MHz: ms a launch with the counters on, each phase's ms a launch, and the
# counts of a launch
WHOLE_SPLIT_BEFORE = {
    "slice": {"ms_per_launch": 49.229, "phase_ms_per_launch": {
        "admit": 1.9629, "try": 17.9625, "commit": 2.5967,
        "advance": 11.8696, "aggregate": 8.9059,
        "barrier": 5.5048},
        "iterations": 3108, "beats": 3825, "tried": 10121,
        "placed": 10121, "prefills": 8096,
        "decode_segments": 44150,
        "decode_iterations": 156483, "recounts": 8123,
        "dominated": 0},
    "optimize 40 workers": {"ms_per_launch": 61.571, "phase_ms_per_launch": {
        "admit": 1.9524, "try": 25.6372, "commit": 2.5967,
        "advance": 13.9079, "aggregate": 11.3533,
        "barrier": 5.6948},
        "iterations": 3108, "beats": 3825, "tried": 10121,
        "placed": 10121, "prefills": 8096,
        "decode_segments": 44150,
        "decode_iterations": 156483, "recounts": 8123,
        "dominated": 0},
    "day": {"ms_per_launch": 984.1521, "phase_ms_per_launch": {
        "admit": 37.2174, "try": 182.0768, "commit": 25.7513,
        "advance": 395.3845, "aggregate": 168.9901,
        "barrier": 162.7266},
        "iterations": 87830, "beats": 436216, "tried": 100369,
        "placed": 100369, "prefills": 92710,
        "decode_segments": 1602994,
        "decode_iterations": 1602994, "recounts": 89034,
        "dominated": 0},
}


def whole_split(torch, args, st, reps: int, smi) -> dict:
    """``reps`` launches of the whole-trace kernel on ``args`` with its
    counters on (``stats``, ``kernels.fastsim.WHOLE_STATS``; the main path
    passes none): each phase's share of the launches' cycles and its ms a
    launch at the SM clock that nvidia-smi reads meanwhile, and the counts
    of a launch. Raises if the counters disagree with the outputs or with
    each other."""
    from repro_torch.kernels.fastsim import WHOLE_STATS, whole_trace
    C = int(args[3].numel())
    stats = torch.zeros((C, len(WHOLE_STATS)), dtype=torch.int64,
                        device=args[0].device)
    with SmClock() as clock:
        for _ in range(reps):
            out = whole_trace(*args, **st, stats=stats)
        torch.cuda.synchronize()
    mhz = clock.median()
    n = int(args[0].shape[0])
    beats = out[4].reshape(C).cpu().tolist()
    finished = (~out[3].reshape(C, n).isnan()).sum(dim=-1).cpu().tolist()
    acc = dict.fromkeys(WHOLE_STATS, 0)
    for c, row in enumerate(stats.cpu().tolist()):
        st_c = dict(zip(WHOLE_STATS, row))
        phases = sum(st_c[f"{k}_cycles"] for k in WHOLE_PHASES)
        if not 0 <= phases <= st_c["cycles"] \
                or st_c["beats"] != reps * beats[c] \
                or st_c["placed"] > reps * n \
                or (finished[c] == n and st_c["placed"] != reps * n) \
                or st_c["dominated"] > st_c["tried"]:
            raise AssertionError(f"[fastsim whole split] candidate {c}: "
                                 f"counters {st_c} disagree (beats "
                                 f"{beats[c]}, {finished[c]} of {n} "
                                 f"finished, {reps} launches)")
        for k, v in st_c.items():
            acc[k] += v
    launches = reps * C
    cyc = acc["cycles"]

    def ms(v):
        return v / launches / (mhz * 1e3)

    return {
        "launches": reps, "candidates": C, "sm_clock_mhz": mhz,
        "ms_per_launch": ms(cyc),
        "phase_ms_per_launch": {k: ms(acc[f"{k}_cycles"])
                                for k in WHOLE_PHASES},
        "share": {k: acc[f"{k}_cycles"] / cyc for k in WHOLE_PHASES},
        **{k: acc[k] // reps for k in (
            "iterations", "beats", "tried", "placed", "prefills",
            "decode_segments", "decode_iterations", "recounts",
            "dominated")},
        "us_per_iteration": ms(cyc) * 1e3 / max(acc["iterations"]
                                                 / launches, 1),
        "card": smi}


# The reference's chunked-core cells (benchmarks/bench_cluster_sim.py:
# run_spot's engine cell, :611-629, and run_feedback's, :718-726, and its
# policy-space optimize, :699-701), built here from the port's copies with
# nothing cut: llama2-70b workers (make_worker_spec(..., A100_80G,
# PAPER_SLOS, mean_context=450.0): live KV), 48 req/s for 150 s.
CHUNK_RATE, CHUNK_SECONDS = 48.0, 150.0
CHUNK_COMPARED = 10          # the spot cell's first chunks, kernel vs plain
PO2_TOL = 0.15               # po2's attainment against the numpy core's
# the chunk kernel's phases (``STATS``' cycle counters, in the order printed)
CHUNK_PHASES = ("admit", "aggregate", "place", "advance", "billing",
                "occupancy")
# the split of the chunk kernel before its redesign (the kernel of commit
# 1846c2c with the counters added), measured by this script's
# ``chunk_split`` on an NVIDIA H100 80GB HBM3 at 700 W, SM clock 1980 MHz:
# phase ms a launch, constraint (e) tests a placement, members of a tested
# lane (mean, largest) and tries a placement
CHUNK_SPLIT_BEFORE = {
    "spot": {"ms_per_launch": 6.9329, "phase_ms_per_launch": {
        "admit": 0.0312, "aggregate": 0.4200, "place": 5.8497,
        "advance": 0.4213, "billing": 0.1463, "occupancy": 0.0216},
        "e_tests_per_placement": 1.0, "members_mean": 24.32,
        "members_max": 43, "tries_per_placement": 7.52},
    "feedback": {"ms_per_launch": 6.6867, "phase_ms_per_launch": {
        "admit": 0.0278, "aggregate": 0.4746, "place": 5.4999,
        "advance": 0.4639, "billing": 0.1523, "occupancy": 0.0226},
        "e_tests_per_placement": 1.0, "members_mean": 23.59,
        "members_max": 44, "tries_per_placement": 10.85}}


class ChunkTimes:
    """Splits the chunked core's host side while the context is open:
    seconds in each of its steps per chunk (``boundary``: the fleet's
    settlement before a chunk; ``pack``; ``up``: the copies to the card;
    ``kernel``: the launch and its run, CUDA events around it, then a
    synchronisation; ``down``: the copies back; ``absorb``: unpacking,
    draining finished rows and the pool's billing replay), the device ms of
    every launch, and the bytes each launch must move (``_chunk_bytes``)."""

    STEPS = (("boundary", "_PooledSim", "step_prepare"),
             ("pack", "_PooledSim", "_pack"), ("up", None, "_to_device"),
             ("kernel", None, "chunk"), ("down", None, "_to_host"),
             ("absorb", "_PooledSim", "step_absorb"))

    def __init__(self, torch, fj):
        self.torch, self.fj = torch, fj
        self.s = {k: 0.0 for k, _, _ in self.STEPS}
        self.ms, self.nbytes = [], []

    def _wrap(self, key, fn):
        torch = self.torch

        def timed(*args, **kw):
            t0 = time.perf_counter()
            if key == "kernel":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                end.synchronize()
                self.ms.append(start.elapsed_time(end))
            else:
                out = fn(*args, **kw)
            self.s[key] += time.perf_counter() - t0
            if key == "kernel":
                self.nbytes.append(_chunk_bytes(args, out))
            return out
        return timed

    def __enter__(self):
        self.saved = []
        for key, owner, name in self.STEPS:
            obj = self.fj if owner is None else getattr(self.fj, owner)
            fn = getattr(obj, name)
            self.saved.append((obj, name, fn))
            setattr(obj, name, self._wrap(key, fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)

    def summary(self, wall_s: float) -> dict:
        n = max(len(self.ms), 1)
        split = {k: v * 1e3 / n for k, v in self.s.items()}
        return {"chunks": len(self.ms),
                "kernel_device_ms_mean": sum(self.ms) / n,
                "kernel_device_ms_max": max(self.ms, default=0.0),
                "host_ms_per_chunk": split,
                "run_wall_ms": wall_s * 1e3,
                "outside_chunks_ms": wall_s * 1e3 - sum(self.s.values()) * 1e3,
                "bound_ms_per_chunk": sum(self.nbytes) / n / HBM_BYTES_PER_S
                * 1e3}


class SmClock:
    """The SM clock in MHz (``nvidia-smi --query-gpu=clocks.sm``), read
    over and over on a thread while the context is open."""

    def __enter__(self):
        self.mhz, self._stop = [], threading.Event()

        def poll():
            while not self._stop.is_set():
                out = subprocess.run(
                    ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True).stdout.strip()
                if out.isdigit():
                    self.mhz.append(int(out))
                self._stop.wait(0.05)

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def median(self) -> float:
        if not self.mhz:
            raise AssertionError("[fastsim chunk] nvidia-smi gave no SM "
                                 "clock")
        return float(sorted(self.mhz)[len(self.mhz) // 2])


def chunk_split(torch, fj, run, smi) -> dict:
    """``run()`` once more with the chunk kernel's counters on (``stats``,
    ``kernels.fastsim.STATS``; the main path passes none): each phase's
    share of the launches' cycles and its ms a launch at the SM clock that
    nvidia-smi reads meanwhile, the placements, constraint (e) tests and the
    members of the tested lanes."""
    from repro_torch.kernels.fastsim import STATS, chunk
    acc = dict.fromkeys(STATS, 0)
    launches = 0

    def counted(*args, **kw):
        nonlocal launches
        stats = torch.zeros((args[0].shape[0], len(STATS)),
                            dtype=torch.int64, device=args[0].device)
        out = chunk(*args, stats=stats, **kw)
        for row in stats.cpu().tolist():
            for k, v in zip(STATS, row):
                acc[k] = max(acc[k], v) if k == "members_max" \
                    else acc[k] + v
        launches += 1
        return out

    inner, fj.chunk = fj.chunk, counted
    try:
        with SmClock() as clock:
            run()
    finally:
        fj.chunk = inner
    mhz = clock.median()
    cyc = acc["cycles"]
    phases = {k: acc[f"{k}_cycles"] for k in CHUNK_PHASES}
    if sum(phases.values()) > cyc:
        raise AssertionError(f"[fastsim chunk] split: phases {phases} "
                             f"exceed the launches' {cyc} cycles")
    place = {k: acc[f"{k}_cycles"] for k in ("try", "commit")}
    return {
        "launches": launches, "sm_clock_mhz": mhz,
        "place_ms_per_launch": {k: v / launches / (mhz * 1e3)
                                for k, v in place.items()},
        "tries_with_a_lane": acc["any_lane"],
        "tries_pruned": acc["dominated"],
        "ms_per_launch": cyc / launches / (mhz * 1e3),
        "share": {k: v / cyc for k, v in phases.items()},
        "phase_ms_per_launch": {k: v / launches / (mhz * 1e3)
                                for k, v in phases.items()},
        "beats": acc["beats"], "tried": acc["tried"],
        "placed": acc["placed"],
        "tries_per_placement": acc["tried"] / max(acc["placed"], 1),
        "e_tests_per_try": acc["e_tests"] / max(acc["tried"], 1),
        "e_tests": acc["e_tests"],
        "e_tests_per_placement": acc["e_tests"] / max(acc["placed"], 1),
        "members_mean": acc["members"] / max(acc["e_tests"], 1),
        "members_max": acc["members_max"], "card": smi}


def _held_states(torch, got, want, what: str) -> float:
    """A chunk's advanced state from the kernel against the plain
    version's: equal, NaN where NaN. Returns the largest absolute
    difference (0)."""
    (fg, ig), (fw, iw) = got, want
    fg, ig = fg.cpu(), ig.cpu()
    if not torch.equal(ig, iw):
        raise AssertionError(f"[fastsim chunk] {what}: int64 state differs "
                             f"at {int((ig != iw).sum())} places")
    if not torch.equal(fg.isnan(), fw.isnan()):
        raise AssertionError(f"[fastsim chunk] {what}: NaNs differ")
    ok = ~fw.isnan()
    err = float((fg[ok] - fw[ok]).abs().max()) if bool(ok.any()) else 0.0
    if err != 0.0:
        raise AssertionError(f"[fastsim chunk] {what}: float64 state "
                             f"differs by up to {err}")
    return err


def _chunk_bytes(args, out) -> int:
    """The bytes one chunk launch must move: every candidate's packed state
    read once and written once, and, for each request it admits to the
    backlog and each row it places, that request's ten trace and sink
    values (arrival, lengths, rank, SLO budgets, re-entrant sinks), 8 B
    each. The rest of the trace is not read in the chunk."""
    from repro_torch.kernels.fastsim import chunk_layout
    _nf, _ni, fields = chunk_layout(1, 1, 1)        # the scalars lead
    ins, outs = args[1].cpu(), out[1].cpu()
    touched = sum(int((outs[:, fields[k][1]] - ins[:, fields[k][1]]).sum())
                  for k in ("idx", "seqc"))
    return 8 * (2 * (args[0].numel() + args[1].numel()) + 10 * touched)


def _held_request_bits(want, got, what: str) -> None:
    key = lambda r: (r.arrival, r.id)  # noqa: E731
    if len(want) != len(got):
        raise AssertionError(f"[fastsim chunk] {what}: {len(got)} requests, "
                             f"want {len(want)}")
    for a, b in zip(sorted(want, key=key), sorted(got, key=key)):
        fa = (a.t_first_token, a.t_finish, a.l_out, a.t_decode_spent,
              a.t_preempted, a.preempt_count)
        fb = (b.t_first_token, b.t_finish, b.l_out, b.t_decode_spent,
              b.t_preempted, b.preempt_count)
        if fa != fb:
            raise AssertionError(f"[fastsim chunk] {what}: request {a.id}: "
                                 f"{fb} != {fa}")


def chunked_phase(torch, smi):
    """The chunked core (``kernels/fastsim/csrc/chunk.cu``): (a) the pooled
    twins of ``repro_torch.serving.chunk_twins``, every chunk through the
    kernel against the plain version's recorded state and each whole run
    on the card against the plain run, and the hand-made order-edge chunk;
    (b) the spot cell's first CHUNK_COMPARED chunks, kernel against plain,
    timed; then the main path, the launch counter zeroed before and read
    after: (c) the spot and feedback cells on the card against the numpy
    core, request by request; (d) optimize(policy_space=...) on both
    engines; (e) po2 on the spot cell, twice. Returns the kernels-line
    case and the main path's launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.scaling import SpotMixConfig
    from repro_torch.core.slo import PAPER_SLOS
    from repro_torch.core.worker_config import (A100_80G, make_worker_spec,
                                                spot_variant)
    from repro_torch.kernels.fastsim import STATS, chunk, chunk_layout
    from repro_torch.serving import api, chunk_twins
    from repro_torch.serving import fastsim_jax as fj
    from repro_torch.serving import workload as wl
    from repro_torch.serving.fastsim import run_colocated_vectorized
    from repro_torch.serving.forecast import (ForecastConfig,
                                              ForecastPolicy,
                                              ScaleSimConfig,
                                              SeasonalNaiveForecaster,
                                              SpotMarket)

    cuda = torch.device("cuda")

    # (a) the pooled twins (repro_torch.serving.chunk_twins): every chunk
    # of the plain run replayed through the kernel, then the whole run on
    # the card against the plain run; and the hand-made chunk that only the
    # numpy core's summation order of the weighted context places
    err = 0.0
    t0 = time.perf_counter()
    for what, make in chunk_twins.TWINS.items():
        sc = make()
        plain_t = wl.clone_trace(sc.workload)
        calls = chunk_twins.record_chunks(lambda: fj.run_colocated_jax(
            dataclasses.replace(sc, workload=plain_t), device="cpu"))
        for k, (args, kw, want, _s) in enumerate(calls):
            got = chunk(*(a.to(cuda) for a in args), **kw)
            err = max(err, _held_states(torch, got, want,
                                        f"{what}, chunk {k}"))
        card_t = wl.clone_trace(sc.workload)
        rep = fj.run_colocated_jax(dataclasses.replace(sc, workload=card_t))
        _held_request_bits(plain_t, card_t, what)
        log(f"[fastsim chunk twin] {what}: {len(card_t)} requests, "
            f"{len(calls)} chunks held, beats {rep.beats}, attainment "
            f"{rep.attainment}, preempted workers {rep.preempted_workers}, "
            f"requeued {rep.requeued}")
    args, kw = chunk_twins.order_edge_chunk()
    want = chunk(*args, **kw)
    got = chunk(*(a.to(cuda) for a in args), **kw)
    err = max(err, _held_states(torch, got, want, "order edge"))
    _nf, _ni, fields = chunk_layout(kw["W"], kw["B"], kw["Q"])
    if int(want[1][0, fields["qlen"][1]]) != 0:
        raise AssertionError("[fastsim chunk] order edge: the request was "
                             "not placed")
    log(f"[fastsim chunk] {len(chunk_twins.TWINS)} twins and the order "
        f"edge: every chunk and every run equal on the card and the plain "
        f"version; {time.perf_counter() - t0:.1f}s wall")

    # the cells, from the port's copies
    slo = PAPER_SLOS["llama2-70b"]
    spec = make_worker_spec(get_arch("llama2-70b"), A100_80G, slo,
                            mean_context=450.0)
    if spec.perf.kv.h == 0.0 and spec.perf.kv.j == 0.0:
        raise AssertionError("[fastsim chunk] the cells' spec has inert KV")
    hazard, discount = 1.0 / 600.0, 0.35
    spot_spec = spot_variant(spec, price=discount, preempt_hazard=hazard)
    lengths = dict(in_mu=5.0, in_sigma=1.1, out_mu=5.3, out_sigma=0.9)

    def spot_cell(engine, policy="aladdin"):
        cfg = wl.WorkloadConfig(mean_rate=CHUNK_RATE,
                                duration=CHUNK_SECONDS, seed=21, **lengths)
        scfg = ScaleSimConfig(interval=5.0, provision_delay=10.0,
                              cooldown=60.0,
                              initial_workers=int(CHUNK_RATE))
        fc = SeasonalNaiveForecaster(ForecastConfig(period=300.0,
                                                    bin_width=5.0))
        mix = SpotMixConfig(discount=discount, hazard=hazard,
                            max_spot_frac=0.7)
        return api.Scenario(
            workload=lambda: wl.diurnal_trace(cfg, amplitude=0.6,
                                              period=300.0),
            fleet=api.FleetSpec([api.PoolSpec(spec, scfg.initial_workers)]),
            slo=slo, topology=api.Colocated(policy=policy),
            scaling=api.PolicyScale(ForecastPolicy(scfg, fc, spot_mix=mix),
                                    scfg),
            market=SpotMarket(spot_spec, wl.preemption_trace(
                CHUNK_SECONDS, event_rate=hazard / 0.25, frac=0.25,
                seed=13)),
            engine=engine)

    def feedback_cell(engine, rate=CHUNK_RATE, duration=CHUNK_SECONDS):
        cfg = wl.WorkloadConfig(mean_rate=rate, duration=duration, seed=33,
                                **lengths)
        return api.Scenario(
            workload=lambda: wl.drifting_diurnal_trace(
                cfg, amplitude=0.6, period=150.0, drift=1.0),
            fleet=api.FleetSpec([api.PoolSpec(spec, 5)]), slo=slo,
            topology=api.Colocated(),
            scaling=api.FeedbackScale(
                base=api.Forecast(period=150.0, min_workers=2),
                min_gain=0.85, max_gain=1.3, boost=1.2, decay=0.02,
                window=45.0),
            engine=engine)

    # (b) the spot cell's first chunks: the plain version's, then the
    # kernel on each recorded state, timed with CUDA events
    sim = fj._PooledSim(spot_cell("jax"), device="cpu")

    def first_chunks():
        for _ in range(CHUNK_COMPARED):
            K = sim.step_prepare()
            (f, i), = fj._run_chunks([sim], [K])
            sim.step_absorb(f, i)

    calls = chunk_twins.record_chunks(first_chunks)
    dev_ms, nbytes, tokens, work = [], [], 0, []
    for k, (args, kw, want, _s) in enumerate(calls):
        dargs = [a.to(cuda) for a in args]
        stats = torch.zeros((1, len(STATS)), dtype=torch.int64, device=cuda)
        chunk(*dargs, **kw, stats=stats)                # warm, counted
        work.append(dict(zip(STATS, stats[0].tolist())))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = chunk(*dargs, **kw)
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
        err = max(err, _held_states(torch, got, want, f"spot cell chunk {k}"))
        nbytes.append(_chunk_bytes(args, want))
        # tokens decoded in the chunk: l_out summed over its rows after,
        # less what the rows held before (a new row's l_out starts at its
        # re-entrant sink's)
        _nf, _ni, fields = chunk_layout(kw["W"], kw["B"], kw["Q"])
        o_lo, o_rid, o_sst = (fields[x][1] for x in ("rlo", "rid", "sst"))
        wb = kw["W"] * kw["B"]
        lo_in = args[1][0, o_lo:o_lo + wb]
        lo_out = want[1][0, o_lo:o_lo + wb]
        occ_in = args[1][0, o_sst:o_sst + wb] > 0
        occ_out = want[1][0, o_sst:o_sst + wb] > 0
        same = occ_in & (args[1][0, o_rid:o_rid + wb]
                         == want[1][0, o_rid:o_rid + wb])
        tokens += int(lo_out[occ_out].sum() - lo_in[same].sum()
                      - args[8][0][want[1][0, o_rid:o_rid + wb][
                          occ_out & ~same]].sum())
    plain_ms = sum(c[3] for c in calls) / len(calls) * 1e3
    kern_ms = sum(dev_ms) / len(dev_ms)
    # operations: at least the 4 fp64 operations of a decode iteration for
    # every max batch of generated tokens
    b_ms, b_by = bound(sum(nbytes) / len(nbytes),
                       {"fp64": 4.0 * tokens / len(calls)
                        / int(spec.max_batch)})
    W, B, Q = calls[0][1]["W"], calls[0][1]["B"], calls[0][1]["Q"]
    case = {"kernel": "fastsim_chunk",
            "case": f"spot cell, first {len(calls)} chunks, W {W} B {B}",
            "dtype": "fp64", "max_abs_err": err, "kernel_ms": kern_ms,
            "device_ms": kern_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}
    log(json.dumps(case))
    log("[fastsim chunk first chunks] " + json.dumps({
        "first_ms": dev_ms[0], "tenth_ms": dev_ms[min(9, len(dev_ms) - 1)],
        **{k: [c[k] for c in work] for k in ("beats", "tried", "dominated",
                                             "placed", "e_tests",
                                             "members")},
        "W_B_Q": [[c[1]["W"], c[1]["B"], c[1]["Q"]] for c in calls],
        "device_ms": dev_ms, "plain_ms": [c[3] * 1e3 for c in calls],
        "bytes": nbytes, "tokens_decoded": tokens, "card": smi}))

    # the kernel's counters over the spot and feedback cells, outside the
    # main path (their launches synchronise to read the counters)
    for what, make in (("spot", spot_cell), ("feedback", feedback_cell)):
        split = chunk_split(torch, fj, lambda: api.run(make("jax")), smi)
        log(f"[fastsim chunk split] {what}, before the redesign "
            "(recorded): " + json.dumps(CHUNK_SPLIT_BEFORE[what]))
        log(f"[fastsim chunk split] {what}: " + json.dumps(split))

    # the main path: the cells on the card, the launch counter zeroed just
    # before and read just after
    chunk.launches = 0

    def cell(make):
        tr = make("vectorized").materialize()
        vec_t, card_t = wl.clone_trace(tr), wl.clone_trace(tr)
        t0 = time.perf_counter()
        vec = run_colocated_vectorized(dataclasses.replace(
            make("vectorized"), workload=vec_t))
        vec_wall = time.perf_counter() - t0
        with ChunkTimes(torch, fj) as times:
            t0 = time.perf_counter()
            rep = api.run(dataclasses.replace(make("jax"), workload=card_t))
            wall = time.perf_counter() - t0
        return vec, vec_t, rep, card_t, vec_wall, times.summary(wall)

    for what, make in (("spot", spot_cell), ("feedback", feedback_cell)):
        vec, vec_t, rep, card_t, vec_wall, split = cell(make)
        _held_request_bits(vec_t, card_t, f"{what} cell")
        for k in ("beats", "gpu_seconds", "spot_gpu_seconds", "epochs",
                  "preempted_workers", "drained_ok", "requeued",
                  "peak_workers"):
            if getattr(rep, k) != getattr(vec, k):
                raise AssertionError(f"[fastsim chunk] {what} cell: {k} "
                                     f"{getattr(rep, k)} != "
                                     f"{getattr(vec, k)}")
        _held_rows(vec.row(), rep.row(), f"{what} cell")
        log(f"[fastsim chunk {what}] " + json.dumps({
            "requests": len(card_t), "finished": rep.finished,
            "beats": rep.beats, "epochs": len(rep.epochs["serve"]),
            "peak_workers": rep.peak_workers,
            "gpu_seconds": rep.gpu_seconds, "attainment": rep.attainment,
            "preempted_workers": rep.preempted_workers,
            "requeued": rep.requeued, "numpy_core_wall_ms": vec_wall * 1e3, **split, "card": smi}))

    # (d) the policy-space search on both engines
    space = {"headroom": (0.9, 1.0, 1.1), "theta": (0.8, 0.9)}
    plans = {}
    for engine in ("jax", "vectorized"):
        with ChunkTimes(torch, fj) as times:
            t0 = time.perf_counter()
            plans[engine] = api.optimize(
                feedback_cell(engine, rate=6.0, duration=900.0),
                attain_target=0.99, policy_space=space)
            wall = time.perf_counter() - t0
        p = plans[engine]
        log("[fastsim chunk optimize] " + json.dumps({
            "engine": engine, "params": p.params, "evals": p.evals,
            "n_workers": p.n_workers, "gpu_seconds": p.cost,
            "attainment": p.report.attainment, "wall_s": wall,
            **({"launches": len(times.ms),
                **{k: times.summary(wall)[k] for k in (
                    "kernel_device_ms_mean", "kernel_device_ms_max",
                    "bound_ms_per_chunk")}} if engine == "jax" else {}),
            "card": smi}))
    jp, vp = plans["jax"], plans["vectorized"]
    if (jp.params, jp.n_workers, jp.cost, jp.evals) \
            != (vp.params, vp.n_workers, vp.cost, vp.evals):
        raise AssertionError(f"[fastsim chunk] optimize: jax {jp.params} "
                             f"{jp.cost}, vectorized {vp.params} {vp.cost}")
    _held_rows(vp.report.row(), jp.report.row(), "optimize")
    replay = api.run(jp.scenario)
    if replay.row() != jp.report.row():
        raise AssertionError("[fastsim chunk] optimize: run(plan.scenario) "
                             f"{replay.row()} != {jp.report.row()}")

    # (e) po2: its own generator, deterministic; the numpy core's
    # attainment within PO2_TOL
    rows = []
    with ChunkTimes(torch, fj) as po2_times:    # the first run, timed
        t0 = time.perf_counter()
        rows.append(api.run(spot_cell("jax", "po2")).row())
        po2_split = po2_times.summary(time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows.append(api.run(spot_cell("jax", "po2")).row())
    wall = time.perf_counter() - t0
    if rows[0] != rows[1]:
        raise AssertionError("[fastsim chunk] po2: two runs differ")
    vec = run_colocated_vectorized(spot_cell("vectorized", "po2"))
    if abs(rows[0]["attainment"] - vec.attainment) > PO2_TOL:
        raise AssertionError(f"[fastsim chunk] po2: attainment "
                             f"{rows[0]['attainment']} vs the numpy core's "
                             f"{vec.attainment}")
    log("[fastsim chunk po2] " + json.dumps({
        "attainment": rows[0]["attainment"],
        "numpy_core_attainment": vec.attainment,
        "finished": rows[0]["finished"], "run_wall_ms": wall * 1e3,
        **{k: po2_split[k] for k in ("chunks", "kernel_device_ms_mean",
                                     "kernel_device_ms_max",
                                     "bound_ms_per_chunk")},
        "card": smi}))
    launches = chunk.launches
    if launches < 1:
        raise AssertionError("[fastsim chunk] the kernel never ran on the "
                             "main path")
    return case, launches


# The distribution phase's ranks. Gloo, the one backend that takes two
# ranks on one card (NCCL refuses them), segfaults in its all-gather of
# CUDA tensors (all_gather_into_tensor, and with it DTensor's Shard ->
# Replicate) with the torch build measured on one H100; its all-reduce,
# reduce-scatter and all-to-all ran (PERF.md). Decode gathers the query
# heads and the new token's K/V, so prefill and decode run on a one-rank
# mesh (DIST_RANKS), where the logits must equal the unsharded LM's, and
# a prefill alone on a two-rank mesh (DIST_TP_RANKS: heads, d_ff and the
# K/V heads over "model"; the row-parallel products' all-reduce and the
# cache's Shard(2) -> Shard(1) all-to-all), within DIST_TOL.
DIST_RANKS = 1
DIST_TP_RANKS = 2
DIST_PREFILL = (2, 1024)                   # batch, prompt
DIST_STEPS = 16
DIST_TOL = 2e-2                            # of the logits' largest value


def _dist_rank(rank, n, init, out, layers):
    """One rank of ``dist_phase`` (spawned): granite-3-8b (``layers`` deep,
    default all 40) under ``make_policy`` on a (1, n) ("data", "model")
    mesh, random bf16 weights from seed 0 (each rank draws every leaf and
    keeps its shard), a prefill of DIST_PREFILL (cold, then warm, its
    collectives counted by ``CommDebugMode``) and, on one rank,
    DIST_STEPS greedy decode steps; launches of B2 and B3 counted per
    prefill and per step; one warm prefill and one step profiled. Then
    the same LM without a policy on the same weights and tokens (rank 0;
    timed on one rank): each pass's logits against the sharded ones.
    Each rank writes its results to ``out`` + its rank."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.debug import CommDebugMode

        from repro_torch.configs import ShapeSpec, get_arch
        from repro_torch.distributed.sharding import make_policy
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.models.model import LM
        arch = get_arch("granite-3-8b")
        if layers:
            arch = dataclasses.replace(arch, n_layers=layers)
        b, s = DIST_PREFILL
        mesh = init_device_mesh("cuda", (1, n),
                                mesh_dim_names=("data", "model"))
        policy = make_policy(arch, ShapeSpec("prefill_1k", "prefill", s, b),
                             mesh)
        model = LM(arch, policy, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            2, arch.vocab, (b, s)), device="cuda")
        res = {"rank": rank, "ranks": n, "layers": arch.n_layers,
               "mesh": [1, n], "wq_local": list(
                   params["seg0"]["wq"].to_local().shape),
               "k_big_placements": None, "prefill": [], "steps": []}

        def counted(fn):
            flash_attention.launches = rmsnorm.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_ = fn()
            torch.cuda.synchronize()
            return out_, 1e3 * (time.perf_counter() - t0), (
                flash_attention.launches, rmsnorm.launches)

        with torch.no_grad():
            for _ in range(2):                        # cold, then warm
                with CommDebugMode() as comms:
                    (lg, cache), ms, ln = counted(
                        lambda: model.prefill(params, toks))
                res["prefill"].append({"ms": ms, "b2": ln[0], "b3": ln[1]})
            res["prefill_collectives"] = {
                str(k).split(".")[-1]: v
                for k, v in comms.get_comm_counts().items()}
            res["k_big_placements"] = str(tuple(cache[0]["k_big"]
                                                .placements))
            logits = [lg.to_local().float()]
            tokens = [logits[0].argmax(-1)]
            for _ in range(DIST_STEPS if n == 1 else 0):
                (lg, cache), ms, ln = counted(
                    lambda: model.decode_step(params, cache, tokens[-1]))
                logits.append(lg.to_local().float())
                tokens.append(logits[-1].argmax(-1))
                res["steps"].append({"ms": ms, "b2": ln[0], "b3": ln[1]})
            prof = _device_ms_by_kernel(
                torch, lambda: model.prefill(params, toks), n=1,
                host_keys=("gloo", "c10d"))
            res["profile_prefill"] = dict(_summary(
                prof[:2], res["prefill"][1]["ms"]), host_ms=prof[2])
            if n == 1:
                res["profile_step"] = _summary(_device_ms_by_kernel(
                    torch, lambda: model.decode_step(params, cache,
                                                     tokens[-1]),
                    n=3), float(np.mean([r["ms"] for r in res["steps"]])))
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(logits[0].cpu(), f"{out}{rank}.pt")
        if rank == 0:
            del params, cache
            ref = LM(arch, device="cuda")
            rp = ref.init(torch.Generator(device="cuda").manual_seed(0))
            errs, ref_ms = [], {"prefill": [], "steps": []}
            with torch.no_grad():
                for _ in range(2):                    # cold, then warm
                    (rl, rc), ms, _ = counted(lambda: ref.prefill(rp, toks))
                    ref_ms["prefill"].append(ms)
                for i, lg in enumerate(logits):
                    if i:
                        (rl, rc), ms, _ = counted(lambda: ref.decode_step(
                            rp, rc, tokens[i - 1]))
                        ref_ms["steps"].append(ms)
                    errs.append(float((lg - rl.float()).abs().max()
                                      / rl.float().abs().max()))
                    if not bool(torch.isfinite(lg).all()):
                        raise AssertionError(f"dist: step {i}: non-finite "
                                             "logits")
            res["max_rel_err"] = errs
            res["unsharded_ms"] = ref_ms
            res["tokens"] = [int(t[0]) for t in tokens]
        with open(f"{out}{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _dist_spawn(torch, n, layers) -> list:
    """``_dist_rank`` on ``n`` spawned ranks (a gloo group through a
    ``file://`` store); every rank's results, rank 0's first, and each
    rank's prefill logits."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        mp.spawn(_dist_rank, args=(n, "file://" + os.path.join(
            tmp, "store"), out, layers), nprocs=n, join=True)
        res = []
        for r in range(n):
            with open(f"{out}{r}.json") as f:
                res.append(json.load(f))
            res[-1]["logits"] = torch.load(f"{out}{r}.pt")
    return res


def dist_phase(torch, smi, layers=None) -> dict:
    """The sharded forward of ``LM`` (distribution, A11) on the card:
    granite-3-8b at full width (``layers`` cuts its depth) under
    ``make_policy``, ranks spawned (start method spawn) on cuda:0 in a
    gloo group: prefill and decode on DIST_RANKS, rank 0's logits equal
    to the unsharded ``LM``'s; a prefill on DIST_TP_RANKS, the heads over
    "model", every rank's logits alike and rank 0's within DIST_TOL of
    their largest value. B2 once per layer per prefill and B3 2 x layers
    + 1 times per prefill and per step, on every rank's local shards.
    Then, on the host only, the dry run of granite-3-8b's decode_32k and
    train_4k cells (``python -m repro_torch.launch.dryrun``): per-device
    peak GB, dot FLOPs, collective bytes by kind and trace seconds,
    counts derived from shapes, not times."""
    import numpy as np
    torch.cuda.empty_cache()
    res = {}
    for n, tol in ((DIST_RANKS, 0.0), (DIST_TP_RANKS, DIST_TOL)):
        ranks = _dist_spawn(torch, n, layers)
        r0 = res[n] = ranks[0]
        logits0 = r0["logits"]
        for r in ranks:
            passes = r["prefill"] + r["steps"]
            for i, p in enumerate(passes):
                want = (r0["layers"] if i < len(r["prefill"]) else 0,
                        2 * r0["layers"] + 1)
                if (p["b2"], p["b3"]) != want:
                    raise AssertionError(
                        f"dist: {n} rank(s), rank {r['rank']}, pass {i}: "
                        f"B2/B3 launched {(p['b2'], p['b3'])}, not {want}")
            if not torch.equal(r.pop("logits"), logits0):
                raise AssertionError(f"dist: rank {r['rank']}'s logits "
                                     "differ from rank 0's")
        if max(r0["max_rel_err"]) > tol:
            raise AssertionError(f"dist: {n} rank(s): logits off the "
                                 f"unsharded LM by {max(r0['max_rel_err'])}"
                                 f" of their largest (limit {tol})")
        ref = r0["unsharded_ms"]
        decode = (f"decode {np.mean([p['ms'] for p in r0['steps']]):.2f} ms"
                  f" a step over {len(r0['steps'])} (unsharded "
                  f"{np.mean(ref['steps']):.2f}); " if r0["steps"] else "")
        log(f"[dist] granite-3-8b, {r0['layers']} layers, {n} rank(s) on "
            f"mesh {r0['mesh']}, wq local {r0['wq_local']}, cache "
            f"{r0['k_big_placements']}; prefill B={DIST_PREFILL[0]} "
            f"S={DIST_PREFILL[1]} cold {r0['prefill'][0]['ms']:.1f} ms, "
            f"warm {r0['prefill'][1]['ms']:.1f} ms (unsharded "
            f"{ref['prefill'][0]:.1f}, {ref['prefill'][1]:.1f}); {decode}"
            f"collectives a prefill {json.dumps(r0['prefill_collectives'])};"
            f" max |logits - unsharded| / max {max(r0['max_rel_err']):.3g} "
            f"(limit {tol}); peak {r0['peak_mem_gb']:.1f} GB; card {smi}")
        log(f"[dist] {n} rank(s): prefill by kernel "
            + json.dumps(r0["profile_prefill"]))
        if "profile_step" in r0:
            log(f"[dist] {n} rank(s): decode step by kernel "
                + json.dumps(r0["profile_step"]))
    log("[dist] collectives: gloo carries them through host memory "
        "(host_ms: their host time), so their time says nothing of NVLink;"
        " on one rank DTensor issues none")
    if layers is None:
        res["dryrun"] = dryrun_cells()
    return res


def dryrun_cells() -> dict:
    """``python -m repro_torch.launch.dryrun`` for granite-3-8b's
    decode_32k and train_4k cells on the host: each record's per-device
    numbers (counts from shapes, not measurements on any chip)."""
    import tempfile
    out = {}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for shape in ("decode_32k", "train_4k"):
        with tempfile.TemporaryDirectory() as tmp:
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 "granite-3-8b", "--shape", shape, "--out", tmp],
                capture_output=True, text=True, env=env, timeout=600)
            if r.returncode:
                raise AssertionError(f"dryrun {shape}: {r.stdout[-2000:]}"
                                     f"{r.stderr[-2000:]}")
            with open(os.path.join(tmp, f"granite-3-8b_{shape}_pod1.json")
                      ) as f:
                rec = json.load(f)
        out[shape] = rec
        log(f"[dryrun] granite-3-8b/{shape} (host counts, {rec['n_devices']}"
            f" fake ranks): peak {rec['peak_bytes_per_device'] / 1e9:.2f} "
            f"GB a device, dot FLOPs {rec['hlo_dot_flops']:.4g}, "
            f"collectives " + json.dumps(rec["collectives"])
            + f", trace {rec['trace_s']} s")
    return out


def grad_refusals(torch):
    """B1 has no backward: on CUDA it raises when an input requires grad,
    before any launch."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    dev = "cuda"
    q = torch.randn(2, 8, 128, device=dev, requires_grad=True)
    kp = torch.randn(4, 16, 8, 128, device=dev)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    ln = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    before = paged_decode_attention.launches
    try:
        paged_decode_attention(q, kp, kp, bt, ln)
    except RuntimeError as e:
        if paged_decode_attention.launches != before:
            raise AssertionError("paged_decode_attention launched before "
                                 "refusing")
        log("[refusal] paged_decode_attention with an input that requires "
            f"grad: RuntimeError: {e}")
        return
    raise AssertionError("paged_decode_attention took an input that "
                         "requires grad")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_backward
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] TF32 off: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds()})")
    for line in _build.ptxas_log().splitlines():
        if any(w in line for w in ("registers", "spill", "==",
                                   "Function properties", "arning")):
            log("[build] " + line.strip())
    b1 = ptxas_report(_build.ptxas_log(),
                      PORT_KERNELS["paged_decode_attention"])
    log("[build] B1 ptxas: " + json.dumps(b1))
    if _build.build_seconds() is not None and (len(b1) < 2 or any(
            v.get("spill_stores", 1) or v.get("spill_loads", 1)
            for v in b1.values())):
        raise AssertionError(f"B1: ptxas spills, or no report: {b1}")

    timer = Timer(torch)
    cases = kernel_phases(torch, F, timer)
    reference_check(torch)
    counters = (paged_decode_attention, flash_attention, rmsnorm)
    launches, arch, params, w32 = main_path(torch, counters)
    gc.collect()                    # the cluster and its engines
    breakdown(torch, arch, params, w32)
    del params, w32                 # free llama2-7b and its fp32 copy
    gc.collect()                    # before the Mamba phases
    torch.cuda.empty_cache()
    log(f"[free] llama2-7b freed: memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    cases += ssd_kernel_phase(torch, timer)
    generation_reference_check(torch, (("mamba2-1.3b", 4), ("zamba2-7b", 5)),
                               batch=2, prompts=(45, 64))
    counters += (ssd_scan,)
    ssm = generation_path(torch, counters, "mamba2-1.3b",
                          runs=((4, 2048, 64), (2, 1000, 16)), window=256,
                          must_launch=("rmsnorm", "ssd_scan"))
    gc.collect()
    torch.cuda.empty_cache()
    generation_path(torch, counters, "zamba2-7b",
                    runs=((2, 1024, 48),), window=32,
                    must_launch=("flash_attention", "rmsnorm", "ssd_scan"))
    launches["ssd_scan"] = ssm["ssd_scan"]
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    generation_reference_check(torch, (("qwen2-moe-a2.7b", 4),
                                       ("moonshot-v1-16b-a3b", 4)),
                               batch=8, prompts=(40,))
    log(f"[moe] reference check: {time.perf_counter() - t0:.1f}s wall")
    t0 = time.perf_counter()
    generation_path(torch, counters, "qwen2-moe-a2.7b",
                    runs=((2, 1024, 32),), window=16,
                    must_launch=("flash_attention", "rmsnorm"))
    log(f"[moe] qwen2-moe-a2.7b path: {time.perf_counter() - t0:.1f}s "
        f"wall; card {smi}")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    vlm_reference_check(torch)
    log(f"[vlm] reference check: {time.perf_counter() - t0:.1f}s wall")
    t0 = time.perf_counter()
    generation_path(torch, counters, "llama-3.2-vision-90b",
                    runs=((2, 1024, 32),), window=16, depth=10,
                    must_launch=("flash_attention", "rmsnorm"))
    log(f"[vlm] llama-3.2-vision-90b path (10 layers): "
        f"{time.perf_counter() - t0:.1f}s wall; card {smi}")
    gc.collect()
    torch.cuda.empty_cache()

    examples_on_card(torch)

    t0 = time.perf_counter()
    cases += training_kernel_cases(torch, F, timer, smi)
    log(f"[train kernels] {time.perf_counter() - t0:.1f}s wall")
    t0 = time.perf_counter()
    cases += ssd_bwd_phase(torch, timer, smi)
    log(f"[ssd_scan_backward] {time.perf_counter() - t0:.1f}s wall")
    t0 = time.perf_counter()
    training_reference_check(torch)
    log(f"[train reference] {time.perf_counter() - t0:.1f}s wall")
    counters += (ssd_scan_backward, flash_attention_backward,
                 rmsnorm_backward)
    for name, layers, steps, remat in TRAIN_PATHS:
        t0 = time.perf_counter()
        got = training_path(torch, counters, smi, name, layers, steps,
                            remat)
        if name == "mamba2-1.3b":
            launches["ssd_scan_backward"] = got["ssd_scan_backward"]
        if name == "granite-3-8b":
            for row, counter in BWD_COUNTERS.items():
                launches[row] = got[counter]
        log(f"[train {name}] path ({layers} layers): "
            f"{time.perf_counter() - t0:.1f}s wall")
    train_example_on_card(torch)
    grad_refusals(torch)

    t0 = time.perf_counter()
    fastsim_case, fastsim_launches = fastsim_phase(torch, smi)
    log(f"[fastsim] Scenario phase: {time.perf_counter() - t0:.1f}s wall; "
        f"card {smi}")
    t0 = time.perf_counter()
    chunk_case, chunk_launches = chunked_phase(torch, smi)
    log(f"[fastsim chunk] chunked-core phase: "
        f"{time.perf_counter() - t0:.1f}s wall; card {smi}")
    gc.collect()
    t0 = time.perf_counter()
    dist_phase(torch, smi)
    log(f"[dist] distribution phase: {time.perf_counter() - t0:.1f}s wall; "
        f"card {smi}")

    representative = {"rmsnorm": "1024x4096",
                      "flash_attention": "B=1 Sq=1024 Skv=1024 H=32/32 D=128",
                      "paged_decode_attention": "B=8 H=32/32 D=128 page=16 "
                                                "max_pages=64 lengths<=1024",
                      "ssd_scan": "B=4 S=2048 H=64 P=64 G=1 N=128 Q=256 "
                                  "init",
                      "ssd_scan_backward": "B=2 S=4096 H=64 P=64 G=1 N=128 "
                                           "Q=256",
                      "flash_attention_bwd": "B=2 Sq=4096 Skv=4096 H=32/8 "
                                             "D=128 (training)",
                      "rmsnorm_bwd": "8192x4096 (training)"}
    kernels = []
    for name in ("paged_decode_attention", "flash_attention", "rmsnorm",
                 "ssd_scan", "ssd_scan_backward", "flash_attention_bwd",
                 "rmsnorm_bwd"):
        rep = next(c for c in cases if c["kernel"] == name
                   and c["case"] == representative[name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["kernel"] == name),
            "ms": rep["kernel_ms"], "device_ms": rep["device_ms"],
            "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "at": rep["case"],
            "dtype": rep["dtype"]})
    for name, c, n in (("fastsim_whole_trace", fastsim_case,
                        fastsim_launches),
                       ("fastsim_chunk", chunk_case, chunk_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": n,
            "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
            "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None, "at": c["case"], "dtype": c["dtype"]})
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("kernel time not measured")
    log(smi)                       # nvidia-smi name, power.limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
