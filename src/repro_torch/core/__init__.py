"""Aladdin's core, copied from the reference package (Eqs. 1-7,
Algorithms 1-2). The H100 spec the port sizes workers with is in
``core.hardware``, which is the port's own.

  perf_model     — Eqs. 1-4 (KV / prefill / decode latency models + fitting)
  worker_config  — Eqs. 5-6 (optimal TP degree per worker)
  placement      — §4.2 MIP constraints + Algorithm 1 best-fit (+ JSQ/Po2
                   baselines)
  rebalance      — §4.3 Algorithm 2 (prediction-error re-balancing)
  scaling        — §5.2 Eq. 7 autoscaler + change-point detection
  distributed_scheduler — Appendix A grouped scheduling
  mip            — exact reference solver (tests)
"""
from repro_torch.core.perf_model import (DecodeModel, KVModel, PerfModel,
                                         PrefillModel, TraceBuffer,
                                         analytic_perf_model)
from repro_torch.core.placement import (PlacementConfig, WorkerState,
                                        best_fit_place, jsq_place,
                                        power_of_two_place)
from repro_torch.core.rebalance import ErrorTracker, rebalance
from repro_torch.core.request import ReqState, Request
from repro_torch.core.scaling import (AttainmentController, Autoscaler,
                                      AutoscalerConfig, FeedbackConfig,
                                      SpotMixConfig, split_spot_mix)
from repro_torch.core.slo import (PAPER_SLOS, SLO, slo_attainment,
                                  slo_metric_ok, windowed_attainment)
from repro_torch.core.worker_config import (A100_80G, TPU_V5E, V100_32G,
                                            HardwareSpec, WorkerConfig,
                                            WorkerSpec, make_worker_spec,
                                            optimal_worker_config,
                                            spot_variant)
from repro_torch.core.distributed_scheduler import (GroupedScheduler,
                                                    SchedLatencyModel,
                                                    choose_group_count)
from repro_torch.core.mip import exact_min_workers

__all__ = [
    "DecodeModel", "KVModel", "PerfModel", "PrefillModel",
    "TraceBuffer", "analytic_perf_model", "PlacementConfig", "WorkerState",
    "best_fit_place", "jsq_place", "power_of_two_place", "ErrorTracker",
    "rebalance", "ReqState", "Request", "AttainmentController", "Autoscaler",
    "AutoscalerConfig", "FeedbackConfig", "SpotMixConfig", "split_spot_mix",
    "PAPER_SLOS", "SLO", "slo_attainment", "slo_metric_ok",
    "windowed_attainment", "A100_80G", "TPU_V5E", "V100_32G", "HardwareSpec",
    "WorkerConfig", "WorkerSpec", "make_worker_spec", "optimal_worker_config",
    "spot_variant", "GroupedScheduler", "SchedLatencyModel",
    "choose_group_count", "exact_min_workers",
]
