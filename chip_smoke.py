#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py            # from the repository root, one CUDA card

1. Prints the card (``nvidia-smi`` name and power limit) and turns TF32 off
   for fp32 matmuls and convolutions.
2. Builds the port's CUDA kernels from ``src/repro_torch/kernels/**/csrc``
   with nvcc for sm_90a, and prints the build time and ptxas's register and
   spill report.
3. Kernel phases: each kernel (B1 paged decode, B2 flash attention, B3
   RMSNorm) runs through its wrapper on the card at the main path's shapes,
   is held against its plain PyTorch version on the same inputs (allclose,
   rtol = atol = 2e-5 in fp32 and 2e-2 in bf16), and is timed with CUDA
   events beside its plain version, a PyTorch library call computing the
   same function where one exists, and its bound: the larger of the bytes
   it must move over 3.35 TB/s and its operations over the peak rate of
   their type (989 TFLOP/s bf16 tensor core, 67 TFLOP/s fp32), the H100
   SXM datasheet figures.
4. Small reference check: the port's engine on the card and on the CPU
   (plain versions) generate the same tokens for a reduced fp32 model,
   one-shot and chunked prefill.
5. Main path: a ``ServingCluster`` of 2 ``PagedEngine`` workers sharing one
   full-width ``llama2-7b`` (random bf16 weights from a seed; default pool
   of 512 pages x 16 tokens, fp32 KV, per worker) serves a Poisson trace of
   12 requests at 8/s (prompts 64-960 tokens, 16-32 output tokens) with
   ``policy="aladdin"`` (Algorithm 1 placement, Algorithm 2 re-balancing)
   and one engine iteration per worker per heartbeat, until drained. Launch counters are zeroed just before and read just
   after; every kernel must have run. The engines' TraceBuffers refit the
   Eq. 2/3 models on the card's iteration times.
6. Breakdown: one more engine on the same weights; prefill time at each
   bucket (cold, then warm) and a decode step at batch 8 x 512-token
   contexts, each on the host clock, with device time by kernel from
   torch.profiler.
7. Prints ``{"kernels": [...]}``, then, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the repository beside it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM datasheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
TOL = {"fp32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}

REPLACES = {
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:72",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:76",
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:33",
}
SOURCES = {
    "paged_decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/paged_decode.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rmsnorm": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
}


def log(*a) -> None:
    print(*a, flush=True)


def bound(nbytes: float, flops: float, kind: str):
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops
            else "operations")


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


def check_close(torch, got, want, kind: str, what: str) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, **TOL[kind]):
        raise AssertionError(f"{what}: max abs err {err} outside {TOL[kind]}")
    return err


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

    def record(kernel, case, kind, err, k_ms, p_ms, l_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops, kind)
        row = {"kernel": kernel, "case": case, "dtype": kind,
               "max_abs_err": err, "tol": TOL[kind], "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        cases.append(row)
        log(json.dumps(row))

    # ---- B3 RMSNorm: prefill rows in bf16, decode rows in fp32 ------------
    d = 4096
    for rows, kind, with_res in ((1024, "bf16", False), (64, "bf16", False),
                                 (8, "fp32", False), (1024, "bf16", True),
                                 (8, "fp32", True)):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        x = randn((rows, d), dt)
        w = randn((d,), torch.bfloat16)          # weights are bf16 params
        r = randn((rows, d), dt) if with_res else None
        err = check_close(torch, rmsnorm(x, w, r, eps=1e-5),
                          rmsnorm_ref(x, w, r, 1e-5), kind,
                          f"rmsnorm {rows}x{d} {kind}")
        k_ms = timer(lambda: rmsnorm(x, w, r, eps=1e-5))
        p_ms = timer(lambda: rmsnorm_ref(x, w, r, 1e-5))
        l_ms = None
        if r is None and dt == w.dtype:
            l_ms = timer(lambda: F.rms_norm(x, (d,), w, 1e-5))
        n_in = rows * d * (2 if with_res else 1)
        nbytes = (n_in + rows * d) * x.element_size() + d * w.element_size()
        flops = rows * d * (4 + (1 if with_res else 0))
        record("rmsnorm", f"{rows}x{d}{' +residual' if with_res else ''}",
               kind, err, k_ms, p_ms, l_ms, nbytes, flops)

    # ---- B2 flash attention: prefill buckets in bf16, chunked in fp32 -----
    def attn_pairs(sq, skv, q_offset, kv_hi):
        rows = torch.arange(sq, dtype=torch.float64) + q_offset + 1
        return float(torch.clamp(rows, max=kv_hi).sum())

    for sq, skv, hq, hkv, kind, q_offset, kv_len in (
            (128, 128, 32, 32, "bf16", 0, None),
            (512, 512, 32, 32, "bf16", 0, None),
            (1024, 1024, 32, 32, "bf16", 0, None),
            (1024, 1024, 32, 8, "bf16", 0, None),
            (256, 768, 32, 32, "fp32", 512, 768),
            (256, 768, 32, 32, "bf16", 512, 700)):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        hd = 128
        q = randn((1, sq, hq, hd), dt)
        k = randn((1, skv, hkv, hd), dt)
        v = randn((1, skv, hkv, hd), dt)
        kl = None if kv_len is None else torch.tensor(
            [kv_len], dtype=torch.int32, device=dev)

        def kern():
            return flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                   kv_len=kl)

        def plain():
            return flash_attention_ref(q, k, v, causal=True,
                                       q_offset=q_offset, kv_len=kl)
        err = check_close(torch, kern(), plain(), kind,
                          f"flash {sq}x{skv} {hq}/{hkv} {kind}")
        l_ms = None
        if q_offset == 0 and kv_len is None and sq == skv:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            gqa = {"enable_gqa": True} if hq != hkv else {}
            l_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **gqa))
        kv_hi = skv if kv_len is None else kv_len
        pairs = attn_pairs(sq, skv, q_offset, kv_hi)
        esz = q.element_size()
        nbytes = (2 * sq * hq * hd + 2 * kv_hi * hkv * hd) * esz
        flops = 4.0 * pairs * hq * hd
        case = f"B=1 Sq={sq} Skv={skv} H={hq}/{hkv} D={hd}" + (
            f" q_offset={q_offset} kv_len={kv_len}" if q_offset else "")
        record("flash_attention", case, kind, err, timer(kern),
               timer(plain), l_ms, nbytes, flops)

    # ---- B1 paged decode over the engine's page pool ----------------------
    n_pages, page, max_pages, hd = 512, 16, 64, 128
    for b, hq, hkv, kind in ((1, 32, 32, "fp32"), (8, 32, 32, "fp32"),
                             (8, 32, 8, "fp32"), (8, 32, 32, "bf16")):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        q = randn((b, hq, hd), dt)
        kp = randn((n_pages, page, hkv, hd), dt)
        vp = randn((n_pages, page, hkv, hd), dt)
        lengths = torch.randint(1, max_pages * page + 1, (b,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[0] = max_pages * page                      # one full seq
        bt = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        used = 0
        for i in range(b):                   # distinct pages; rest -> null
            n = -(-int(lengths[i]) // page)
            if used + n > n_pages - 1:
                used = 0
            bt[i, :n] = perm[used:used + n].to(torch.int32)
            used += n
        err = check_close(
            torch, paged_decode_attention(q, kp, vp, bt, lengths),
            paged_decode_ref(q, kp, vp, bt, lengths), kind,
            f"paged decode B={b} {hq}/{hkv} {kind}")
        k_ms = timer(lambda: paged_decode_attention(q, kp, vp, bt, lengths))
        p_ms = timer(lambda: paged_decode_ref(q, kp, vp, bt, lengths))
        toks = float(lengths.sum())
        esz = q.element_size()
        nbytes = (2 * toks * hkv * hd + 2 * b * hq * hd) * esz \
            + bt.numel() * 4 + b * 4
        flops = 4.0 * toks * hq * hd
        record("paged_decode_attention",
               f"B={b} H={hq}/{hkv} D={hd} page={page} max_pages={max_pages}"
               f" lengths<={max_pages * page}", kind, err, k_ms, p_ms, None,
               nbytes, flops)
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
    n_params = sum(t.numel() for t in params.values() if torch.is_tensor(t)) \
        + sum(t.numel() for t in params["seg0"].values())
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return launches, arch, params


def _device_ms_by_kernel(torch, fn, n=3):
    """Device time per call of ``fn`` by kernel name, from torch.profiler
    over n calls (device-side events only)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total / 1e3 / n
        if t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t
    return by_name


def _summary(by_name, wall_ms):
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    if not busy:
        log("[breakdown] the profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def breakdown(torch, arch, params, batch=8, prompt=512, steps=10):
    """Where an iteration's time goes, at fixed shapes on a fresh engine
    sharing the main path's weights: prefill at each bucket (host clock
    around ``LM.prefill`` ending in a host read, cold then warm) with
    device time by kernel at the 64 and 1024 buckets, and decode at ``batch``
    sequences of ``prompt``-token contexts."""
    import numpy as np

    from repro_torch.core.request import Request
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    eng = PagedEngine(arch, params, EngineConfig(), device="cuda")
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
    dec = _summary(_device_ms_by_kernel(torch, eng.step),
                   float(np.mean(times)))
    dec.update(batch=batch, context=prompt, step_ms_min=min(times))
    log("[breakdown] decode " + json.dumps(dec))


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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

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
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build] " + line.strip())

    timer = Timer(torch)
    cases = kernel_phases(torch, F, timer)
    reference_check(torch)
    counters = (paged_decode_attention, flash_attention, rmsnorm)
    launches, arch, params = main_path(torch, counters)
    breakdown(torch, arch, params)

    representative = {"rmsnorm": "1024x4096",
                      "flash_attention": "B=1 Sq=1024 Skv=1024 H=32/32 D=128",
                      "paged_decode_attention": "B=8 H=32/32 D=128 page=16 "
                                                "max_pages=64 lengths<=1024"}
    kernels = []
    for name in ("paged_decode_attention", "flash_attention", "rmsnorm"):
        rep = next(c for c in cases if c["kernel"] == name
                   and c["case"] == representative[name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["kernel"] == name),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "at": rep["case"],
            "dtype": rep["dtype"]})
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
