"""Continuous-batching performance models (paper §3, Eqs. 1-4).

All three models are linear with learnable coefficients, fitted online from
execution traces (the paper's workflow step "continuously update the
performance model according to the worker's execution traces"):

  Eq. 1  kv(t)          = h * t + j                  (bytes per context token)
  Eq. 2  t_pre(L)       = k1 * L + c1                (L = total batched input)
  Eq. 3  t_d(b, l_ave)  = (k2 * l_ave + c2) * b + c3
                        =  k2 * C + c2 * b + c3      (C = total context)
  Eq. 4  C_max(b)       = (T_dec - c3 - c2 * b) / k2 (total-context budget)

The decode model is fitted in the (C, b) parameterization — identical to the
paper's but numerically better conditioned than (l_ave, b).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class KVModel:
    h: float = 0.0
    j: float = 0.0

    def __call__(self, tokens) -> np.ndarray:
        return self.h * np.asarray(tokens, dtype=np.float64) + self.j

    @staticmethod
    def fit(tokens: Sequence[float], kv_bytes: Sequence[float]) -> "KVModel":
        A = np.stack([np.asarray(tokens, np.float64),
                      np.ones(len(tokens))], axis=1)
        (h, j), *_ = np.linalg.lstsq(A, np.asarray(kv_bytes, np.float64),
                                     rcond=None)
        return KVModel(float(h), float(j))


@dataclasses.dataclass
class PrefillModel:
    k1: float = 0.0
    c1: float = 0.0

    def __call__(self, total_input) -> np.ndarray:
        return self.k1 * np.asarray(total_input, np.float64) + self.c1

    def max_total_input(self, t_pre_budget: float) -> float:
        """Invert Eq. 2: largest Σ l_in admissible within the TTFT budget."""
        if self.k1 <= 0:
            return float("inf")
        return max((t_pre_budget - self.c1) / self.k1, 0.0)

    @staticmethod
    def fit(total_inputs, times) -> "PrefillModel":
        A = np.stack([np.asarray(total_inputs, np.float64),
                      np.ones(len(times))], axis=1)
        (k1, c1), *_ = np.linalg.lstsq(A, np.asarray(times, np.float64),
                                       rcond=None)
        return PrefillModel(float(k1), float(c1))


@dataclasses.dataclass
class DecodeModel:
    k2: float = 0.0
    c2: float = 0.0
    c3: float = 0.0

    def __call__(self, batch, total_context) -> np.ndarray:
        b = np.asarray(batch, np.float64)
        c = np.asarray(total_context, np.float64)
        return self.k2 * c + self.c2 * b + self.c3

    def iteration_time(self, batch, total_context):
        return self(batch, total_context)

    def max_total_context(self, batch: float, t_dec: float) -> float:
        """Eq. 4: the total-context budget at batch size b under ATGT t_dec."""
        if self.k2 <= 0:
            return float("inf")
        return max((t_dec - self.c3 - self.c2 * batch) / self.k2, 0.0)

    def max_batch(self, t_dec: float, l_ave: float) -> int:
        """Largest b with t_d(b, b*l_ave) <= t_dec (used by Eq. 6's B)."""
        denom = self.k2 * l_ave + self.c2
        if denom <= 0:
            return 10 ** 9
        return max(int((t_dec - self.c3) / denom), 0)

    @staticmethod
    def fit(batches, total_contexts, times) -> "DecodeModel":
        A = np.stack([np.asarray(total_contexts, np.float64),
                      np.asarray(batches, np.float64),
                      np.ones(len(times))], axis=1)
        (k2, c2, c3), *_ = np.linalg.lstsq(A, np.asarray(times, np.float64),
                                           rcond=None)
        return DecodeModel(float(k2), float(c2), float(c3))


@dataclasses.dataclass
class PerfModel:
    """Bundle of the three fitted models + fit diagnostics."""
    kv: KVModel = dataclasses.field(default_factory=KVModel)
    prefill: PrefillModel = dataclasses.field(default_factory=PrefillModel)
    decode: DecodeModel = dataclasses.field(default_factory=DecodeModel)
    max_rel_err: dict = dataclasses.field(default_factory=dict)

    # ---- online refit from traces ------------------------------------------
    def update_from_traces(self, traces: "TraceBuffer") -> None:
        """Trimmed refit: JIT-compile events produce latency outliers; fit,
        drop points with residual > 5x the median absolute residual, refit."""
        def trimmed(fit, xs_cols, ys):
            m = fit(*xs_cols, ys)
            pred = m(*xs_cols) if len(xs_cols) > 1 else m(xs_cols[0])
            res = np.abs(np.asarray(pred) - np.asarray(ys, np.float64))
            med = np.median(res) + 1e-12
            keep = res <= 5 * med
            if keep.sum() >= max(4, 0.5 * len(ys)) and not keep.all():
                cols = [np.asarray(c)[keep] for c in xs_cols]
                ys2 = np.asarray(ys, np.float64)[keep]
                m = fit(*cols, ys2)
                pred = m(*cols) if len(cols) > 1 else m(cols[0])
                return m, _max_rel_err(pred, ys2)
            return m, _max_rel_err(pred, ys)

        if len(traces.prefill_inputs) >= 4:
            self.prefill, err = trimmed(
                lambda x, y: PrefillModel.fit(x, y),
                [traces.prefill_inputs], traces.prefill_times)
            self.max_rel_err["prefill"] = err
        if len(traces.decode_batches) >= 6:
            self.decode, err = trimmed(
                lambda b, c, y: DecodeModel.fit(b, c, y),
                [traces.decode_batches, traces.decode_contexts],
                traces.decode_times)
            self.max_rel_err["decode"] = err
        if len(traces.kv_tokens) >= 4:
            self.kv = KVModel.fit(traces.kv_tokens, traces.kv_bytes)
            pred = self.kv(traces.kv_tokens)
            self.max_rel_err["kv"] = _max_rel_err(pred, traces.kv_bytes)


def _max_rel_err(pred, actual) -> float:
    actual = np.asarray(actual, np.float64)
    pred = np.asarray(pred, np.float64)
    denom = np.maximum(np.abs(actual), 1e-12)
    return float(np.max(np.abs(pred - actual) / denom))


@dataclasses.dataclass
class TraceBuffer:
    """Rolling buffer of worker execution traces (workflow steps 3/4)."""
    cap: int = 4096
    prefill_inputs: list = dataclasses.field(default_factory=list)
    prefill_times: list = dataclasses.field(default_factory=list)
    decode_batches: list = dataclasses.field(default_factory=list)
    decode_contexts: list = dataclasses.field(default_factory=list)
    decode_times: list = dataclasses.field(default_factory=list)
    kv_tokens: list = dataclasses.field(default_factory=list)
    kv_bytes: list = dataclasses.field(default_factory=list)

    def record_prefill(self, total_input: int, t: float) -> None:
        self.prefill_inputs.append(total_input)
        self.prefill_times.append(t)
        self._trim()

    def record_decode(self, batch: int, total_context: int, t: float) -> None:
        self.decode_batches.append(batch)
        self.decode_contexts.append(total_context)
        self.decode_times.append(t)
        self._trim()

    def record_kv(self, tokens: int, nbytes: float) -> None:
        self.kv_tokens.append(tokens)
        self.kv_bytes.append(nbytes)
        self._trim()

    def _trim(self) -> None:
        for name in ("prefill_inputs", "prefill_times", "decode_batches",
                     "decode_contexts", "decode_times", "kv_tokens",
                     "kv_bytes"):
            lst = getattr(self, name)
            if len(lst) > self.cap:
                del lst[: len(lst) - self.cap]


def analytic_perf_model(arch, hw_tflops: float = 197.0,
                        hw_hbm_gbs: float = 819.0, n_chips: int = 1,
                        efficiency: float = 0.5) -> PerfModel:
    """First-principles seed model (used by the simulator before any traces
    exist): prefill is compute-bound (6*N_active FLOPs/token), decode is
    weight+KV bandwidth-bound."""
    n_active = arch.param_count(active_only=True)
    flops_tok = 2.0 * n_active
    peak = hw_tflops * 1e12 * n_chips * efficiency
    bw = hw_hbm_gbs * 1e9 * n_chips * efficiency
    kv_tok = arch.kv_bytes_per_token()
    weight_bytes = 2.0 * arch.param_count()
    k1 = flops_tok / peak
    # decode iteration: read all weights once (+c3) and each context token's
    # KV (k2 per context token); c2 = per-sequence fixed overhead.
    k2 = kv_tok / bw
    c3 = weight_bytes / bw
    c2 = flops_tok / peak
    return PerfModel(kv=KVModel(h=float(kv_tok), j=float(arch.ssm_state_bytes())),
                     prefill=PrefillModel(k1=float(k1), c1=1e-3),
                     decode=DecodeModel(k2=float(k2), c2=float(c2),
                                        c3=float(c3)))
