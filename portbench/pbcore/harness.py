"""One run of one cell: set-up, the measured window, the drain, the
readings, the check. ``run.py`` calls ``run_cell`` on the card; the tests
call it on the CPU with a reduced configuration."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

from pbcore import check, serve
from pbcore.spec import Bench, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Obs:
    """Everything a reader may read."""
    cell: Cell
    cfg: Dict
    seconds: float
    setup_s: float
    served: serve.Served
    observer: serve.Observer
    slo: Dict
    trace: object = None            # devtrace.Trace of the traced span
    trace_steps: tuple = (0, 0)     # observer.steps[a:b] inside the span
    launches: Dict = dataclasses.field(default_factory=dict)

    def _untraced(self, t0: float, t1: float) -> bool:
        """Outside the traced span, whose profiler slows the host."""
        tr = self.trace
        return tr is None or t1 < tr.window[0] or t0 > tr.window[1]

    def window_steps(self) -> List[serve.Step]:
        """Engine iterations that ended inside the window, outside the
        traced span."""
        s = self.served
        return [st for st in self.observer.steps
                if s.t0 <= st.t1 <= s.t_end and self._untraced(st.t0, st.t1)]

    def span_steps(self) -> List[serve.Step]:
        a, b = self.trace_steps
        return self.observer.steps[a:b]

    def window_beats(self) -> List[tuple]:
        s = self.served
        return [b for b in s.beats
                if s.t0 <= b[1] <= s.t_end and self._untraced(*b)]

    def per_request(self):
        """[(due, first, finish, l_real)] of every request that arrived;
        None where it never came."""
        o = self.observer
        return [(due, o.first.get(r.id), o.finish.get(r.id), r.l_real)
                for r, due, _ in self.served.requests]


def _counters():
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"paged_decode": lambda: paged_decode_attention.launches,
            "flash_f32": lambda: flash_attention.launches_fp32,
            "flash_bf16": lambda: flash_attention.launches_bf16,
            "rmsnorm": lambda: rmsnorm.launches,
            "ssd_scan": lambda: ssd_scan.launches}


def build_cluster(cell: Cell, arch, weights, device):
    from repro_torch.core.slo import SLO
    from repro_torch.serving.cluster import ClusterConfig, ServingCluster
    from repro_torch.serving.engine import EngineConfig
    w = cell.workload
    cl = dict(w["cluster"])
    n_workers = cl.pop("n_workers")
    return ServingCluster(arch, weights, SLO(ttft=w["slo"]["ttft_s"],
                                             atgt=w["slo"]["atgt_s"]),
                          engine_cfg=EngineConfig(**w["engine"]),
                          cfg=ClusterConfig(**cl), n_workers=n_workers,
                          device=device)


def warm_up(cluster, obs, arrivals, chunk: int, vocab: int) -> None:
    """Serve the warm-up trace (``serve.warm_arrivals``) to its end."""
    warm = serve.warm_arrivals(arrivals, chunk, vocab)
    t = obs.clock()
    done = serve.serve(cluster, obs, warm, warm[-1]["due_s"] + 1e-3,
                       drain_s=300.0)
    if any(r.id not in obs.finish for r, _, _ in done.requests):
        raise RuntimeError("warm-up did not drain")
    from repro_torch.core.request import Request
    largest = Request(l_in=max(a["l_in"] for a in arrivals), l_pred=0)
    largest.l_pred = cluster.predictor.predict(largest.l_in)
    idle_ok = [w.state.feasible([largest]) for w in cluster.workers.values()]
    log(f"[setup] warm-up: {len(warm)} requests (prompts "
        f"{[a['l_in'] for a in warm]}, outputs "
        f"{[a['l_out'] for a in warm]}) in {obs.clock() - t:.3f} s; Eq. 3 "
        f"{cluster.perf.decode}, Eq. 2 {cluster.perf.prefill}; Algorithm 1 "
        f"would place the largest prompt ({largest.l_in}) on an idle "
        f"worker: {idle_ok}")


def run_cell(bench: Bench, cell: Cell, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             clock: Callable[[], float] = time.perf_counter,
             control: bool = False, hooks: Optional[Dict] = None) -> Dict:
    """Set up, serve the window, read, check. Returns the result line's
    fields. With ``control`` the checks judge the control (the reference
    one step below the stated precision) in the program's place, and the
    program's own readings are under ``program``. ``hooks`` (tests only)
    may break the timed path: ``cluster(cluster)`` is called once the
    warm-up has drained."""
    import torch
    from pbcore import devtrace
    cuda = torch.device(device).type == "cuda"
    phases = [("imports", clock())]
    cfg = cell.config
    arch = serve.port_arch(cfg)
    w = cell.workload
    chunk = int(w["engine"].get("prefill_chunk", 0))
    if cuda:
        from repro_torch.kernels import _build
        t = clock()
        _build.build()
        log(f"[setup] kernel library ready in {clock() - t:.3f} s "
            f"(build {_build._state.build_seconds} s)")
    phases.append(("the port's modules and kernel library", clock()))
    weights = serve.make_weights(cfg, seed, device)
    serve.check_layout(arch, weights)
    gen = bench.generator(cell.traffic["kind"])
    arrivals = gen.generate(cell.traffic, seed, seconds, cfg["vocab_size"])
    phases.append(("weights and arrivals", clock()))
    cluster = build_cluster(cell, arch, weights, device)
    obs = serve.Observer(cluster, clock)
    phases.append(("cluster (the fp32 copy, the pools)", clock()))
    warm_up(cluster, obs, arrivals, chunk, cfg["vocab_size"])
    if cuda:
        torch.cuda.synchronize()
    phases.append(("warm-up", clock()))
    prev = t_start
    for name, t in phases:
        log(f"[setup] {name}: {t - prev:.3f} s")
        prev = t
    if hooks and "cluster" in hooks:
        hooks["cluster"](cluster)
    tap = check.LogitTap(cluster)
    n_warm_steps = len(obs.steps)
    counters = _counters()
    span = devtrace.Span(clock) if trace else None
    if span is not None:
        span.warm()
    tr_start = float(w.get("trace_start_frac", 0.25)) * seconds
    tr_len = min(float(w.get("trace_s", 3.0)), 0.9 * seconds - tr_start)
    state = {"stopped": False, "steps": (0, 0), "launch0": None}

    def stop():
        t = clock()
        span.stop()
        state["stopped"] = True
        state["steps"] = (state["steps"][0], len(obs.steps))
        state["launches"] = {k: f() - state["launch0"][k]
                             for k, f in counters.items()}
        state["stop_s"] = clock() - t

    def on_beat(now):
        if span is None or state["stopped"]:
            return
        if span.h0 is None and now >= t0 + tr_start:
            state["steps"] = (len(obs.steps), 0)
            state["launch0"] = {k: f() for k, f in counters.items()}
            t = clock()
            span.start()
            state["start_s"] = clock() - t
        elif span.h0 is not None and now >= span.h0 + tr_len:
            stop()
    t0 = clock()
    setup_s = t0 - t_start
    host0 = host_sample()
    served = serve.serve(cluster, obs, arrivals, seconds,
                         drain_s=float(w["drain_s"]), on_beat=on_beat,
                         t0=t0)
    log_host(host0, host_sample(), obs, served)
    if span is not None and span.h0 is not None and not state["stopped"]:
        stop()
    trace_read = None
    if span is not None and span.h0 is not None:
        t = clock()
        trace_read = span.read()
        log(f"[trace] profiler start {state['start_s']:.3f} s and stop "
            f"{state['stop_s']:.3f} s inside the window; the trace read in "
            f"{clock() - t:.3f} s after the drain")
    late = [sub - due for _, due, sub in served.requests]
    log(f"[window] {len(served.requests)} arrivals over {seconds} s; the "
        f"generator's lateness (submit - due): median "
        f"{1e3 * sorted(late)[len(late) // 2]:.3f} ms, max "
        f"{1e3 * max(late):.3f} ms; drained in "
        f"{served.t_drained - served.t_end:.3f} s after the close; "
        f"{obs.preempted} preemptions; warm-up steps {n_warm_steps}")
    o = Obs(cell=cell, cfg=cfg, seconds=seconds, setup_s=setup_s,
            served=served, observer=obs, slo=w["slo"],
            trace=trace_read, trace_steps=state["steps"],
            launches=state.get("launches", {}))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
                   if cuda else 0}
    metrics, breakdown = read_metrics(bench, cell, o, trace, device_info)
    live = list(cluster.workers)
    cnt = check.counts(served.requests, obs.finish, live, cfg["vocab_size"])
    reqs = check.sample(served.requests, obs.finish, seed,
                        int(w["check"]["served_tokens"]))
    tapped = tap.rows(reqs)
    # the program's state goes before the reference runs
    tap.detach()
    obs.detach()
    del cluster, tap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = clock()
    ref = bench.reference(cfg["reference"])
    got = check.readings(ref, weights, cfg, reqs, tapped, chunk, device,
                         control=control)
    log(f"[check] reference over {len(reqs)} requests, "
        f"{got['tokens_compared']} served tokens, in {clock() - t:.3f} s; "
        f"the program read {got['program']}")
    # the control is judged in the program's place
    judged = got["control"] if control else got["program"]
    checks = {k: {"value": judged[k], "limit": float(w["check"][k])}
              for k in ("max_logit_gap", "max_logit_err")}
    checks.update({"unplaced": {"value": cnt["unplaced"], "limit": 0},
                   "failed": {"value": cnt["failed"], "limit": 0},
                   "wrong_length": {"value": cnt["wrong"], "limit": 0},
                   "tokens_compared": {"value": got["tokens_compared"],
                                       "limit": 1}})
    correct = (all(c["value"] <= c["limit"] for k, c in checks.items()
                   if k != "tokens_compared")
               and got["tokens_compared"] >= 1)
    out = {"correct": bool(correct), "attempted": len(served.requests),
           "failed": cnt["failed"], "metrics": metrics,
           "device": device_info}
    if trace:
        out["breakdown"] = breakdown
    if control:
        out["program"] = got["program"]
    out["checks"] = checks
    return out


def host_sample():
    """(wall, this process's CPU seconds)."""
    return time.perf_counter(), time.process_time()


def log_host(a, b, obs, served) -> None:
    """What the host did while the window ran: this process's share of a
    core, and the mean decode iteration in each fifth of the window (a
    fall across the fifths would be warm-up inside the window; a level
    that differs between runs is the host's speed)."""
    wall = b[0] - a[0]
    fifths = [[] for _ in range(5)]
    span = served.t_end - served.t0
    for st in obs.steps:
        if st.kind == "decode" and served.t0 <= st.t1 < served.t_end:
            fifths[int(5 * (st.t1 - served.t0) / span)].append(st.wall)
    dec = [round(1e3 * sum(f) / len(f), 2) if f else None for f in fifths]
    log(f"[host] over {wall:.1f} s: this process used "
        f"{(b[1] - a[1]) / wall:.3f} of a core; mean decode ms a fifth of "
        f"the window {dec}")


def read_metrics(bench: Bench, cell: Cell, o: Obs, trace: bool,
                 device_info: Dict):
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (``trace`` on), each from its reader; a reader that finds nothing
    returns None and the metric is left out."""
    from pbcore import devtrace
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = bench.reader(m["name"]).read(o)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    breakdown = None
    if trace:
        tr = o.trace
        if tr is None or not tr.ops:
            raise RuntimeError("the traced span saw no device operation")
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(10),
                     "idle_gaps": devtrace.idle_by_host_span(
                         tr, o.span_steps(),
                         [b for b in o.served.beats
                          if tr.window[0] <= b[0] <= tr.window[1]])}
        inside = [s.wall for s in o.span_steps() if s.kind == "decode"]
        outside = [s.wall for s in o.window_steps() if s.kind == "decode"]
        cost = (f"{1e3 * sum(inside) / len(inside):.2f} ms inside the span, "
                f"{1e3 * sum(outside) / len(outside):.2f} outside"
                if inside and outside else "not measured")
        log(f"[trace] span {tr.window_s:.3f} s, busy {tr.busy_s():.3f} s, "
            f"{len(tr.ops)} device operations, marker skew "
            f"{tr.skew if tr.skew is None else round(tr.skew * 1e6, 1)} us; "
            f"launches by the program's counters {o.launches}; mean decode "
            f"iteration {cost}")
    return metrics, breakdown
