"""Cluster manager: Aladdin's control plane over real engine workers,
ported from the reference ``repro.serving.cluster``.

Runs the paper's full loop on live ``PagedEngine`` workers (on one CUDA
card, sharing one weight set and one fp32 copy of its decode weights, or
on the CPU when asked):

  submit -> predict l_out -> best-fit place (Alg. 1) -> engines run
  iteration-level batching -> traces refit the perf models -> re-balance
  (Alg. 2) -> autoscale (Eq. 7).

Fault tolerance: dead workers' in-flight requests are re-queued (prefill
restarts — the paper's no-migration rule means their KV is lost); stragglers
(decode-iteration EMA z-score) are drained and replaced. The scheduler state
(request table, error tracker, perf model) snapshots to a dict for
checkpoint/restart.

Before any trace exists the placement model is the analytic seed of an
H100 SXM (the reference seeds it with TPU v5e figures); the live traces
then refit it. The control-plane
code and its clock reads are the reference's, line for line.

Heartbeats, placement, re-balance and refits are spans of
``serving/spans.py``'s ``RECORDER``, and each request's submission and
placement are instants of it; the recorder reads its own clock, apart from
``time_fn``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.hardware import H100_SXM
from repro_torch.core.perf_model import analytic_perf_model
from repro_torch.core.placement import (PlacementConfig, WorkerState,
                                  best_fit_place, jsq_place)
from repro_torch.core.rebalance import ErrorTracker, rebalance
from repro_torch.core.request import ReqState, Request
from repro_torch.core.scaling import Autoscaler, AutoscalerConfig
from repro_torch.core.slo import SLO
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.engine import EngineConfig, PagedEngine
from repro_torch.serving.length_predictor import LengthPredictor
from repro_torch.serving.spans import RECORDER


@dataclasses.dataclass
class ClusterConfig:
    policy: str = "aladdin"            # aladdin | jsq
    heartbeat_iters: int = 4           # engine iterations per heartbeat
    enable_rebalance: bool = True
    straggler_z: float = 4.0
    autoscale: bool = False
    min_workers: int = 1
    max_workers: int = 8
    gamma: float = 0.5
    theta: float = 0.9
    # session-tagged requests: "sticky" prefers the worker that served the
    # session's previous turn (its KV pages may still hold the shared
    # prefix) whenever that worker passes every placement constraint;
    # "blind" routes every turn like a fresh request
    router: str = "blind"              # blind | sticky


class ClusterWorker:
    def __init__(self, wid: int, engine: PagedEngine, state: WorkerState):
        self.id = wid
        self.engine = engine
        self.state = state
        self.iter_ema: Optional[float] = None

    def observe_iter(self, dt: float) -> None:
        self.iter_ema = dt if self.iter_ema is None \
            else 0.9 * self.iter_ema + 0.1 * dt


class ServingCluster:
    def __init__(self, arch, params, slo: SLO,
                 engine_cfg: EngineConfig = EngineConfig(),
                 cfg: ClusterConfig = ClusterConfig(),
                 n_workers: int = 2,
                 time_fn: Callable[[], float] = time.perf_counter,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.arch = arch
        self.params = params
        self.slo = slo
        self.engine_cfg = engine_cfg
        self.cfg = cfg
        self.time_fn = time_fn
        self.perf = analytic_perf_model(
            arch, hw_tflops=H100_SXM.peak_flops / 1e12,
            hw_hbm_gbs=H100_SXM.hbm_bw / 1e9)
        self.predictor = LengthPredictor()
        self.tracker = ErrorTracker()
        self.autoscaler = Autoscaler(AutoscalerConfig(
            min_workers=cfg.min_workers, max_workers=cfg.max_workers))
        self._wid = 0
        self.w32: Optional[dict] = None     # shared by every worker
        self.workers: Dict[int, ClusterWorker] = {}
        self.queued: List[Request] = []
        self.finished: List[Request] = []
        self.failed_events: List[int] = []
        self.session_home: Dict[int, int] = {}   # session -> last worker
        kv_cap = (engine_cfg.n_pages - 1) * engine_cfg.page_size \
            * arch.kv_bytes_per_token(dtype_bytes=4) / 2
        self.pcfg = PlacementConfig(gamma=cfg.gamma, theta=cfg.theta,
                                    kv_capacity=kv_cap,
                                    max_batch=engine_cfg.max_batch)
        for _ in range(n_workers):
            self._spawn_worker()

    # ---- worker lifecycle ----------------------------------------------------
    def _spawn_worker(self) -> ClusterWorker:
        self._wid += 1
        eng = PagedEngine(self.arch, self.params, self.engine_cfg,
                          time_fn=self.time_fn, device=self.device,
                          w32=self.w32)
        self.w32 = eng.w32          # the first worker's fp32 decode weights
        st = WorkerState(self._wid, self.pcfg, self.perf, self.slo)
        w = ClusterWorker(self._wid, eng, st)
        self.workers[self._wid] = w
        return w

    def inject_failure(self, wid: int) -> int:
        """Kill a worker; re-queue its in-flight requests. Returns #requeued."""
        w = self.workers.pop(wid)
        w.state.alive = False
        requeued = 0
        for r in (w.state.ongoing + w.state.new_batch + w.engine.waiting
                  + w.engine.running):
            if r.state == ReqState.FINISHED or r in self.queued:
                continue
            r.state = ReqState.QUEUED
            r.worker = None
            r.l_out = 0
            r.t_decode_spent = 0.0
            r.cached_len = 0    # the dead worker's KV (and any shared
                                # session prefix on it) is gone
            if r.tokens is not None:
                r.tokens = r.tokens[:r.l_in]
            self.queued.append(r)
            requeued += 1
        # sessions homed on the dead worker re-route like fresh requests
        self.session_home = {s: h for s, h in self.session_home.items()
                             if h != wid}
        self.failed_events.append(wid)
        if len(self.workers) < self.cfg.min_workers:
            self._spawn_worker()
        return requeued

    def _detect_stragglers(self) -> List[int]:
        emas = [(w.id, w.iter_ema) for w in self.workers.values()
                if w.iter_ema is not None]
        if len(emas) < 3:
            return []
        vals = np.asarray([e for _, e in emas])
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        out = []
        for wid, e in emas:
            if (e - med) / (1.4826 * mad) > self.cfg.straggler_z:
                self.workers[wid].state.draining = True
                out.append(wid)
        return out

    # ---- request path ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.l_pred = self.predictor.predict(req.l_in)
        self.queued.append(req)
        RECORDER.instant("request.submit", req.id)

    def _try_home(self, r: Request):
        """Sticky session affinity: the home worker takes the turn only if
        it passes every placement constraint; otherwise fall through to
        the configured policy (never place on an infeasible home)."""
        home = self.workers.get(self.session_home.get(r.session_id))
        if home is None or not home.state.alive or home.state.draining:
            return None
        if home.state.feasible([r]):
            home.state.place(r)
            return home.state
        return None

    def _place_all(self) -> None:
        still = []
        states = [w.state for w in self.workers.values()]
        for r in self.queued:
            st = self._try_home(r) \
                if self.cfg.router == "sticky" and r.session_id >= 0 \
                else None
            if st is None:
                if self.cfg.policy == "aladdin":
                    st = best_fit_place(states, r, allow_new=False)
                else:
                    st = jsq_place(states, r, allow_new=False)
            if st is None and self.cfg.autoscale \
                    and len(self.workers) < self.cfg.max_workers:
                w = self._spawn_worker()
                st = w.state
                st.place(r)
            if st is None:
                still.append(r)
            else:
                r.state = ReqState.PLACED
                RECORDER.instant("request.placed", r.id)
                if self.cfg.router == "sticky" and r.session_id >= 0:
                    self.session_home[r.session_id] = st.id
        self.queued = still

    @RECORDER.traced("cluster.heartbeat")
    def heartbeat(self) -> List[Request]:
        """One control-plane cycle: place, re-balance, run engine iterations,
        refit models, straggler check. Returns newly finished requests."""
        sp = RECORDER.begin("cluster.place")
        self._place_all()
        RECORDER.end(sp)
        if self.cfg.enable_rebalance and self.cfg.policy == "aladdin":
            sp = RECORDER.begin("cluster.rebalance")
            rebalance([w.state for w in self.workers.values()], self.tracker)
            self.tracker.decay()
            RECORDER.end(sp)
        # hand placed requests to engines
        for w in self.workers.values():
            for r in list(w.state.new_batch):
                w.engine.submit(r)
                w.state.new_batch.remove(r)
                w.state.ongoing.append(r)
        newly: List[Request] = []
        for w in list(self.workers.values()):
            for _ in range(self.cfg.heartbeat_iters):
                t0 = self.time_fn()
                done = w.engine.step()
                w.observe_iter(self.time_fn() - t0)
                for r in done:
                    w.state.ongoing.remove(r)
                    self.tracker.on_finish(r)
                    self.predictor.observe(r.l_in, r.l_real or r.l_out)
                    newly.append(r)
            # re-prediction for underruns
            for r in w.state.ongoing:
                if r.l_out > r.l_pred and not r.repredicted:
                    self.tracker.on_underrun(
                        r, self.predictor.repredict(r.l_in, r.l_out))
                    w.state.mark_dirty()
            # refit perf models from live traces (workflow step 3)
            sp = RECORDER.begin("cluster.refit")
            self.perf.update_from_traces(w.engine.traces)
            RECORDER.end(sp)
        self._detect_stragglers()
        # retire drained+empty workers
        for wid, w in list(self.workers.items()):
            if w.state.draining and not w.state.ongoing \
                    and not w.engine.waiting \
                    and len(self.workers) > self.cfg.min_workers:
                del self.workers[wid]
        self.finished.extend(newly)
        return newly

    def run_until_drained(self, max_beats: int = 500) -> None:
        for _ in range(max_beats):
            self.heartbeat()
            if not self.queued and all(
                    not w.state.ongoing and not w.engine.waiting
                    and not w.state.new_batch
                    for w in self.workers.values()):
                break

    # ---- checkpoint / restart ---------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "queued": [(r.id, r.l_in, r.l_pred, r.l_real, r.arrival)
                       for r in self.queued],
            "perf": dataclasses.asdict(self.perf.decode) | {
                "k1": self.perf.prefill.k1, "c1": self.perf.prefill.c1,
                "h": self.perf.kv.h, "j": self.perf.kv.j},
            "tracker_l": dict(self.tracker.l_e),
            "tracker_b": dict(self.tracker.b_e),
            "n_workers": len(self.workers),
        }

    def restore(self, snap: dict) -> None:
        from repro_torch.core.perf_model import (DecodeModel, KVModel,
                                                 PrefillModel)
        p = snap["perf"]
        self.perf.decode = DecodeModel(p["k2"], p["c2"], p["c3"])
        self.perf.prefill = PrefillModel(p["k1"], p["c1"])
        self.perf.kv = KVModel(p["h"], p["j"])
        self.tracker.l_e = dict(snap["tracker_l"])
        self.tracker.b_e = dict(snap["tracker_b"])
        for _, l_in, l_pred, l_real, arr in snap["queued"]:
            r = Request(l_in=l_in, l_pred=l_pred, l_real=l_real, arrival=arr)
            self.queued.append(r)
        while len(self.workers) < snap["n_workers"]:
            self._spawn_worker()

    # ---- metrics -----------------------------------------------------------------
    def attainment(self) -> float:
        if not self.finished:
            return 0.0
        return sum(r.slo_ok(self.slo) for r in self.finished) \
            / len(self.finished)
