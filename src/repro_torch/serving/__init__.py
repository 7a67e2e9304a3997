"""Serving substrate: the declarative Scenario API (``api.run`` /
``api.optimize``) over one simulation engine, plus the paged
continuous-batching engine, cluster control plane, workload generators and
length prediction. ``__all__`` is the supported public surface — guarded by
tests/test_scenario_api.py against drifting from the documented names."""
from repro_torch.serving.api import (Colocated, Disaggregated,             # noqa: F401
                               FeedbackScale, FixedScale, FleetSpec,
                               Forecast, Plan, PolicyScale, PoolSpec,
                               Reactive, RunReport, Scenario, SideOverride,
                               TenantSpec, optimize, run)
from repro_torch.serving.cluster import ClusterConfig, ServingCluster      # noqa: F401
from repro_torch.serving.disagg import (DisaggConfig, DisaggResult,        # noqa: F401
                                  min_cost_disagg, ratio_pool_fn,
                                  simulate_disaggregated)
from repro_torch.serving.engine import EngineConfig, PagedEngine           # noqa: F401
from repro_torch.serving.forecast import (EWMAForecaster, FeedbackPolicy,  # noqa: F401
                                    ForecastConfig, ForecastPolicy,
                                    ReactivePolicy, ScaleSimConfig,
                                    ScaleSimResult, SeasonalNaiveForecaster,
                                    SpotMarket, simulate_autoscaled)
from repro_torch.serving.length_predictor import LengthPredictor           # noqa: F401
from repro_torch.serving.simulator import (SimConfig, SimResult,           # noqa: F401
                                     min_workers_for_slo,
                                     run_heartbeat_loop, simulate)
from repro_torch.serving.tenants import (planning_slo, tenant_rows)        # noqa: F401
from repro_torch.serving.workload import (PreemptionEvent, WorkloadConfig,  # noqa: F401
                                    burst_trace, clone_trace,
                                    diurnal_rate_fn, diurnal_trace,
                                    drifting_diurnal_rate_fn,
                                    drifting_diurnal_trace, generate_trace,
                                    mixture_trace, nonhomogeneous_trace,
                                    preemption_trace, sample_lengths,
                                    session_trace)
from repro_torch.serving.workload import SessionSpec                       # noqa: F401

# The documented public surface (README "Scenario API" + ROADMAP PR-4/5).
__all__ = [
    # declarative Scenario API (repro.serving.api)
    "Scenario", "FleetSpec", "PoolSpec", "Colocated", "Disaggregated",
    "FixedScale", "Reactive", "Forecast", "FeedbackScale", "SideOverride",
    "PolicyScale", "RunReport", "Plan", "run", "optimize",
    # multi-tenant serving (repro.serving.tenants)
    "TenantSpec", "planning_slo", "tenant_rows",
    # markets + scaling policies
    "SpotMarket", "ScaleSimConfig", "ScaleSimResult", "ReactivePolicy",
    "ForecastPolicy", "FeedbackPolicy", "SeasonalNaiveForecaster",
    "EWMAForecaster", "ForecastConfig",
    # legacy simulators (deprecation shims over run()/optimize())
    "SimConfig", "SimResult", "simulate", "min_workers_for_slo",
    "DisaggConfig", "DisaggResult", "simulate_disaggregated",
    "min_cost_disagg", "ratio_pool_fn", "simulate_autoscaled",
    "run_heartbeat_loop",
    # workload generation
    "WorkloadConfig", "generate_trace", "nonhomogeneous_trace",
    "burst_trace", "diurnal_trace", "diurnal_rate_fn",
    "drifting_diurnal_trace", "drifting_diurnal_rate_fn",
    "preemption_trace", "PreemptionEvent", "sample_lengths", "clone_trace",
    "mixture_trace", "SessionSpec", "session_trace",
    # engine + cluster + prediction
    "EngineConfig", "PagedEngine", "ClusterConfig", "ServingCluster",
    "LengthPredictor",
]
