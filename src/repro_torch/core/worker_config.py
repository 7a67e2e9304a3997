"""Optimal worker (tensor-parallel) configuration (paper §4.1, Eqs. 5-6).

Search over TP degrees N_g for the one maximizing per-accelerator decode
throughput:

    t_compute(N_g) = k4 / N_g + c4                      (Eq. 5)
    t_comm(N_g)    = c_comm * (N_g - 1) / N_g           (All-reduce overhead)
    M(N_g)         = N_g * mem - model_bytes            (KV capacity)
    T_max(N_g)     = min( M / (N_g * m_r * t_iter),     (KV-bound)
                          B_slo / (N_g * T_dec) )       (SLO-bound)   (Eq. 6)

where t_iter = t_compute + t_comm at the KV-full batch size and B_slo is the
largest batch whose decode iteration meets the ATGT SLO (via Eq. 3/4).
The optimum is arrival-rate independent (§4.1), so it is computed once per
(model, hardware, SLO) and reused while autoscaling the worker *count*."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.perf_model import (DecodeModel, KVModel, PerfModel,
                                   PrefillModel)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    mem_bytes: float                 # HBM per accelerator
    peak_flops: float                # bf16/fp16 FLOP/s per accelerator
    hbm_bw: float                    # bytes/s
    link_bw: float                   # effective all-reduce bytes/s
    link_latency: float = 10e-6      # per collective op
    max_group: int = 16              # largest TP degree offered


# The paper's A100 testbed is PCIe-connected (its §6.1); effective ring
# all-reduce bandwidth on PCIe 4.0 is ~8 GB/s with ~50us per op. The V100
# testbed is NVLink. TPU v5e ICI per-link ~50 GB/s, ~2us.
TPU_V5E = HardwareSpec("tpu-v5e", mem_bytes=16e9, peak_flops=197e12,
                       hbm_bw=819e9, link_bw=45e9, link_latency=2e-6,
                       max_group=16)
A100_80G = HardwareSpec("a100-80g", mem_bytes=80e9, peak_flops=312e12,
                        hbm_bw=2.0e12, link_bw=8e9, link_latency=25e-6,
                        max_group=8)
V100_32G = HardwareSpec("v100-32g", mem_bytes=32e9, peak_flops=125e12,
                        hbm_bw=0.9e12, link_bw=20e9, link_latency=20e-6,
                        max_group=8)


@dataclasses.dataclass
class WorkerConfig:
    n_accelerators: int
    kv_capacity: float               # M, bytes
    per_gpu_throughput: float        # T_max (req-iterations / s / accel)
    bound: str                       # "kv" | "slo"
    decode_model: DecodeModel


@dataclasses.dataclass
class WorkerSpec:
    """Everything the cluster simulator needs to know about one worker type.

    A heterogeneous fleet is a list of these; each simulated worker carries
    its own spec, so A100 TP=4 and V100 TP=8 workers coexist with their own
    latency models, KV capacities and accelerator costs. ``kv_capacity`` is
    in the same units the spec's KVModel outputs (token units for specs built
    by ``make_worker_spec``); ``kv_bytes_per_token`` is kept separately so
    the disaggregated simulator can price the prefill->decode KV transfer in
    bytes regardless of those units.

    ``price`` and ``preempt_hazard`` describe the worker's market class:
    on-demand capacity is ``price=1.0, preempt_hazard=0`` (the default);
    a spot/preemptible variant of the same hardware bills at a discount but
    can be reclaimed by the provider at any time — ``preempt_hazard`` is the
    per-worker per-second reclaim rate the mix planner
    (``core.scaling.split_spot_mix``) provisions against. Billed cost is
    always ``gpu_cost = n_accelerators * price``."""
    perf: PerfModel
    kv_capacity: float
    max_batch: int = 128
    n_accelerators: int = 1
    name: str = "worker"
    kv_bytes_per_token: float = 0.0
    price: float = 1.0               # $/accelerator-s relative to on-demand
    preempt_hazard: float = 0.0      # per-second reclaim rate (0 = on-demand)
    # LoRA multiplexing (multi-tenant serving): a base-model worker can hold
    # up to ``lora_slots`` resident adapters; each resident adapter eats
    # ``lora_overhead`` of ``kv_capacity`` (same units) for its weights, and
    # faulting a non-resident adapter in stalls the worker ``lora_swap_s``
    # seconds (weight fetch + load). ``lora_slots=0`` means the worker
    # cannot serve LoRA-tenant traffic at all.
    lora_slots: int = 0              # max resident adapters (0 = no LoRA)
    lora_overhead: float = 0.0       # kv_capacity units per resident adapter
    lora_swap_s: float = 0.0         # stall per adapter fault-in, seconds

    @property
    def gpu_cost(self) -> float:
        return float(self.n_accelerators) * self.price

    @property
    def is_spot(self) -> bool:
        return self.price < 1.0 or self.preempt_hazard > 0.0


def spot_variant(spec: WorkerSpec, price: float = 0.35,
                 preempt_hazard: float = 1.0 / 1800.0) -> WorkerSpec:
    """The preemptible twin of an on-demand worker type: same hardware and
    latency models, billed at ``price`` of on-demand, reclaimable at
    ``preempt_hazard`` per second."""
    return dataclasses.replace(spec, name=f"{spec.name}-spot", price=price,
                               preempt_hazard=preempt_hazard)


def make_worker_spec(arch, hw: HardwareSpec, slo,
                     n_g: Optional[int] = None,
                     mean_context: float = 1024.0,
                     max_batch: int = 128,
                     efficiency: float = 0.875,
                     prefill_efficiency: float = 0.5) -> WorkerSpec:
    """Build a simulator-ready WorkerSpec for ``arch`` on ``hw``.

    n_g=None runs the Eq. 5-6 search for the hardware's optimal TP degree;
    an explicit n_g models a fixed (possibly suboptimal) worker shape. The
    KV model is in token units (h=1), with capacity = M / kv-bytes-per-token,
    so constraint (e) compares token counts against a token budget."""
    if n_g is None:
        cfg = optimal_worker_config(arch, hw, slo, mean_context=mean_context,
                                    efficiency=efficiency)
        n_g, dm, M = cfg.n_accelerators, cfg.decode_model, cfg.kv_capacity
    else:
        M = n_g * hw.mem_bytes - 2.0 * arch.param_count()
        if M <= 0:
            raise ValueError(f"{arch.name} does not fit on {n_g}x {hw.name}")
        dm = _decode_model_for(arch, hw, n_g, efficiency)
    kv_tok = arch.kv_bytes_per_token()
    k1 = 2.0 * arch.param_count() / (n_g * hw.peak_flops * prefill_efficiency)
    perf = PerfModel(kv=KVModel(h=1.0, j=0.0),
                     prefill=PrefillModel(k1=k1, c1=0.01),
                     decode=dm)
    return WorkerSpec(perf=perf, kv_capacity=M / kv_tok, max_batch=max_batch,
                      n_accelerators=n_g, name=f"{hw.name}-tp{n_g}",
                      kv_bytes_per_token=kv_tok)


def _decode_model_for(arch, hw: HardwareSpec, n_g: int,
                      efficiency: float = 0.875) -> DecodeModel:
    """Analytic (k2, c2, c3) for a TP group of n_g accelerators (Eq. 5 with
    explicit comm terms): weights and KV reads split n_g ways; tensor
    parallelism pays 2 all-reduces per layer — a fixed latency per iteration
    (c3) and a ring-bandwidth cost per batched token (c2), both scaled by
    the (n_g - 1)/n_g ring factor."""
    n_active = arch.param_count(active_only=True)
    weight_bytes = 2.0 * arch.param_count()
    kv_tok = arch.kv_bytes_per_token()
    bw = hw.hbm_bw * efficiency
    peak = hw.peak_flops * efficiency
    ring = (n_g - 1) / max(n_g, 1)
    n_ar = 2 * arch.n_layers                 # attention + MLP all-reduce
    # per-token all-reduce payload: d_model bf16, x2 for ring traffic
    ar_bytes_tok = n_ar * arch.d_model * 2 * 2
    # ring all-reduce latency: 2*(n_g - 1) hops per op
    c3 = weight_bytes / (n_g * bw) \
        + n_ar * 2 * (n_g - 1) * hw.link_latency
    k2 = kv_tok / (n_g * bw)
    c2 = 2.0 * n_active / (n_g * peak) + ring * ar_bytes_tok / hw.link_bw
    return DecodeModel(k2=k2, c2=c2, c3=c3)


def optimal_worker_config(arch, hw: HardwareSpec, slo,
                          mean_context: float = 1024.0,
                          candidates: Optional[Sequence[int]] = None,
                          efficiency: float = 0.875,
                          kv_dtype_bytes: int = 2) -> WorkerConfig:
    """Pick N_g maximizing Eq. 6's per-accelerator throughput.
    kv_dtype_bytes=1 models an int8-quantized KV cache (serving.kv_quant):
    doubles the capacity M can hold and halves the decode KV-read slope k2."""
    model_bytes = 2.0 * arch.param_count()
    cands = candidates or [g for g in (1, 2, 4, 8, 16) if g <= hw.max_group]
    best: Optional[WorkerConfig] = None
    kv_scale = kv_dtype_bytes / 2.0
    for n_g in cands:
        M = n_g * hw.mem_bytes - model_bytes
        if M <= 0:
            continue
        dm = _decode_model_for(arch, hw, n_g, efficiency)
        dm = DecodeModel(k2=dm.k2 * kv_scale, c2=dm.c2, c3=dm.c3)
        kv_tok = arch.kv_bytes_per_token() * kv_scale
        m_r = kv_tok * mean_context + arch.ssm_state_bytes()   # per-request KV
        b_kv = max(M / max(m_r, 1.0), 1.0)                     # KV-full batch
        t_iter = dm(b_kv, b_kv * mean_context)
        thr_kv = b_kv / (n_g * t_iter)
        b_slo = dm.max_batch(slo.atgt, mean_context)
        thr_slo = b_slo / (n_g * slo.atgt)
        if thr_kv <= thr_slo:
            thr, bound = thr_kv, "kv"
        else:
            thr, bound = thr_slo, "slo"
        cfg = WorkerConfig(n_accelerators=n_g, kv_capacity=M,
                           per_gpu_throughput=thr, bound=bound,
                           decode_model=dm)
        if best is None or cfg.per_gpu_throughput > best.per_gpu_throughput:
            best = cfg
    if best is None:
        raise ValueError(
            f"{arch.name} does not fit on {hw.name} with <= "
            f"{hw.max_group} accelerators per worker")
    return best
