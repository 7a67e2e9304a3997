"""Driving the port's live Aladdin path under open-loop traffic.

The system under test is ``repro_torch.serving.cluster.ServingCluster``
(``submit``, ``heartbeat``) and, through it, its ``PagedEngine`` workers.
The harness makes the weights, builds the cluster from a cell's files,
serves a fixed warm-up trace, then offers the cell's arrivals at their due
times and watches every engine step from the client's side.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from pbcore.spec import layout

# configuration file key -> the port's ArchConfig field
ARCH_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab",
             "head_dim": "head_dim", "tie_word_embeddings": "tie_embeddings",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
             "hidden_act": "act", "attention_bias": "qkv_bias"}
DTYPES = {"bfloat16": "bfloat16", "float32": "float32"}


def port_arch(cfg: Dict):
    """The port's ArchConfig for a configuration file, every size taken
    from the file. Raises where the file's scalars are not what the port
    runs (the file would not describe the run). A configuration that
    names a layout gets its layout module's ``port_arch``."""
    lay = layout(cfg)
    if lay is not None:
        return lay.port_arch(cfg)
    from repro_torch.configs import get_arch
    kw = {field: cfg[key] for key, field in ARCH_KEYS.items() if key in cfg}
    kw["param_dtype"] = DTYPES[cfg["torch_dtype"]]
    arch = dataclasses.replace(get_arch(cfg["port_arch"]), **kw)
    hd = arch.resolved_head_dim
    # each scalar as the port runs it, and as the reference reads a file
    # that leaves it out
    runs = {"embedding_multiplier":
            (math.sqrt(arch.d_model) if arch.tie_embeddings else 1.0, 1.0),
            "attention_multiplier": (1.0 / math.sqrt(hd),) * 2,
            "residual_multiplier": (1.0, 1.0), "logits_scaling": (1.0, 1.0),
            "partial_rotary_factor": (1.0, 1.0)}
    for key, (value, default) in runs.items():
        if not math.isclose(cfg.get(key, default), value, rel_tol=1e-9):
            raise ValueError(f"{cfg['port_arch']}: {key} "
                             f"{cfg.get(key, default)} is not what the port "
                             f"runs ({value})")
    if cfg.get("rope_scaling") is not None:
        raise ValueError("the port's RoPE takes no scaling")
    return arch


def leaf_shapes(cfg: Dict) -> Dict:
    """The weights' layout, nested ``{name: (shape, kind)}`` or ``(shape,
    kind, dtype)`` (see ``make_weights``), as the port's dense ``LM`` takes
    them, or as the configuration's layout module gives it."""
    lay = layout(cfg)
    if lay is not None:
        return lay.leaf_shapes(cfg)
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    ff, V = cfg["intermediate_size"], cfg["vocab_size"]
    qd, kvd = hq * hd, hkv * hd
    seg = {"ln1": ((L, d), "norm"), "ln2": ((L, d), "norm"),
           "wq": ((L, d, qd), d), "wk": ((L, d, kvd), d),
           "wv": ((L, d, kvd), d), "wo": ((L, qd, d), qd),
           "wg": ((L, d, ff), d), "wu": ((L, d, ff), d),
           "wd": ((L, ff, d), ff)}
    return {"embed": ((V, d), "embed"), "final_ln": ((d,), "norm"),
            "seg0": seg}


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """Random weights from ``seed``, on the device, one call a stacked
    leaf in sorted order, each in its leaf's dtype (the configuration's
    where the leaf names none). A leaf's kind says how it is drawn:

    - a number, its fan-in: N(0, 1/fan_in);
    - ``"norm"``, any gain (a norm's weight, Mamba's D): 1 + N(0, 0.1^2),
      not ones, so that a skipped gain shows;
    - ``"embed"``: N(0, 1/d^2). The tied head reads the embedding back: at
      the usual 0.02 a token's own row (scaled by sqrt(d) on the way in)
      would stand some 10 sigma above every other logit, and the model
      would repeat its last token by a margin no rounding could flip; at
      1/d it leads by well under one;
    - ``("normal", sigma)``: N(0, sigma^2), for biases, not zeros, so that
      a skipped bias shows;
    - ``("log_uniform", low, high)``: log U[low, high] (Mamba's A_log)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d = cfg["hidden_size"]

    def make(shape, kind, dtype=cfg["torch_dtype"]):
        dtype = getattr(torch, DTYPES[dtype])

        def randn():
            return torch.randn(shape, generator=gen, device=device,
                               dtype=dtype)
        if kind == "norm":
            return randn().mul_(0.1).add_(1.0)
        if kind == "embed":
            return randn().mul_(1.0 / d)
        if isinstance(kind, (int, float)):
            return randn().mul_(1.0 / math.sqrt(kind))
        draw, *args = kind
        if draw == "normal":
            return randn().mul_(args[0])
        if draw == "log_uniform":
            low, high = args
            return torch.rand(shape, generator=gen, device=device,
                              dtype=dtype).mul_(high - low).add_(low).log_()
        raise ValueError(f"unknown kind of leaf {kind!r}")

    def walk(node):
        return {k: walk(node[k]) if isinstance(node[k], dict)
                else make(*node[k]) for k in sorted(node)}
    return walk(leaf_shapes(cfg))


def check_layout(arch, weights: Dict) -> None:
    """The port's own model must declare the leaves, shapes and dtypes
    made here: those ``LM.init`` gives (on the meta device, so nothing is
    allocated)."""
    from repro_torch.models.model import LM
    tmpl = LM(arch, device="meta").init(None)

    def walk(t, w, path):
        if set(t) != set(w):
            raise ValueError(f"layout {path}: port {sorted(t)}, harness "
                             f"{sorted(w)}")
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], w[k], f"{path}/{k}")
            elif (t[k].shape, t[k].dtype) != (w[k].shape, w[k].dtype):
                raise ValueError(f"layout {path}/{k}: port "
                                 f"{tuple(t[k].shape)} {t[k].dtype}, "
                                 f"harness {tuple(w[k].shape)} "
                                 f"{w[k].dtype}")
    walk(tmpl, weights, "")


@dataclasses.dataclass
class Step:
    wid: int
    t0: float
    t1: float
    kind: str               # prefill | decode | idle
    wall: float = 0.0       # the TraceBuffer's time of the iteration
    tokens: int = 0         # prefill: prompt tokens; decode: live batch
    context: int = 0        # decode: total keys (TraceBuffer's context)
    l_ins: tuple = ()       # prefill: the prompts that got a first token


class Observer:
    """The client's view of a cluster: each worker's ``engine.step`` is
    wrapped to time it on the host clock and to see, right after it
    returns, which requests got their first token, how many tokens came
    and which finished. Also keeps the iteration's TraceBuffer record."""

    def __init__(self, cluster, clock: Callable[[], float]):
        self.clock = clock
        self.first: Dict[int, float] = {}
        self.finish: Dict[int, float] = {}
        self.seen: Dict[int, int] = {}
        self.tokens = 0
        self.preempted = 0
        self.steps: List[Step] = []
        self.cum: List[tuple] = []            # (t1, tokens so far)
        self._orig = {}
        for w in cluster.workers.values():
            self._attach(w.id, w.engine)

    def _attach(self, wid, eng):
        orig = eng.step

        def step(now=None):
            tr = eng.traces
            marks = (_mark(tr.prefill_times), _mark(tr.decode_times))
            t0 = self.clock()
            done = orig(now)
            t1 = self.clock()
            self._after(wid, eng, done, t0, t1, marks)
            return done
        eng.step = step
        self._orig[wid] = eng

    def detach(self) -> None:
        for eng in self._orig.values():
            del eng.step                       # the class's method again
        self._orig = {}

    def _after(self, wid, eng, done, t0, t1, marks):
        tr = eng.traces
        st = Step(wid, t0, t1, "idle")
        new_first = []
        for r in list(eng.running) + list(done):
            cur, prev = r.l_out, self.seen.get(r.id, 0)
            if cur > prev:
                self.tokens += cur - prev
                if r.id not in self.first:
                    self.first[r.id] = t1
                    new_first.append(r.l_in)
            elif cur < prev:
                self.preempted += 1
            self.seen[r.id] = cur
        for r in done:
            self.finish[r.id] = t1
        if _moved(marks[0], tr.prefill_times):
            st.kind, st.wall = "prefill", tr.prefill_times[-1]
            st.tokens, st.l_ins = tr.prefill_inputs[-1], tuple(new_first)
        elif _moved(marks[1], tr.decode_times):
            st.kind, st.wall = "decode", tr.decode_times[-1]
            st.tokens, st.context = (tr.decode_batches[-1],
                                     tr.decode_contexts[-1])
        self.steps.append(st)
        self.cum.append((t1, self.tokens))


def _mark(lst):
    """A list's length and last object: an append shows in one of them
    even where the TraceBuffer trims its front."""
    return len(lst), (lst[-1] if lst else None)


def _moved(mark, lst) -> bool:
    n, last = _mark(lst)
    return n != mark[0] or last is not mark[1]


def idle(cluster) -> bool:
    return not cluster.queued and all(
        not w.state.new_batch and not w.engine.waiting
        and not w.engine.running for w in cluster.workers.values())


@dataclasses.dataclass
class Served:
    """What one window observed."""
    t0: float                      # the first due arrival
    t_end: float                   # the window's close
    t_drained: float
    requests: list                 # [(Request, due, submitted)]
    beats: List[tuple]             # (start, end) of each heartbeat
    tokens_at_close: int           # emitted by steps ending in the window


def serve(cluster, obs: Observer, arrivals: List[Dict], seconds: float,
          drain_s: float, on_beat: Optional[Callable[[float], None]] = None,
          t0: Optional[float] = None) -> Served:
    """Offer ``arrivals`` (due_s from the window's start) open-loop: each
    request is submitted at the first moment the loop finds it due, and
    timed from its due time. Heartbeats run while there is work; the loop
    sleeps to the next due time otherwise. After the close it heartbeats
    until every request has finished, or ``drain_s`` has passed."""
    from repro_torch.core.request import Request
    clock = obs.clock
    t0 = clock() if t0 is None else t0
    t_end = t0 + seconds
    reqs, beats = [], []
    i, n = 0, len(arrivals)
    at_start = obs.tokens
    while True:
        now = clock()
        while i < n and t0 + arrivals[i]["due_s"] <= now:
            a = arrivals[i]
            due = t0 + a["due_s"]
            r = Request(l_in=a["l_in"], l_pred=0, l_real=a["l_out"],
                        arrival=due)
            r.tokens = [int(x) for x in a["tokens"]]
            cluster.submit(r)
            reqs.append((r, due, now))
            i += 1
        if i == n and now >= t_end:
            break
        if idle(cluster):
            nxt = t0 + arrivals[i]["due_s"] if i < n else t_end
            if nxt > now:
                time.sleep(nxt - now)
            continue
        b0 = clock()
        cluster.heartbeat()
        b1 = clock()
        beats.append((b0, b1))
        if on_beat is not None:
            on_beat(b1)
    close = clock()
    at_close = at_start
    for t, cum in obs.cum:
        if t0 <= t <= t_end:
            at_close = cum
    deadline = close + drain_s
    while any(r.id not in obs.finish for r, _, _ in reqs) \
            and clock() < deadline:
        if idle(cluster):
            break                     # nothing left that could finish
        b0 = clock()
        cluster.heartbeat()
        beats.append((b0, clock()))
    return Served(t0=t0, t_end=t_end, t_drained=clock(), requests=reqs,
                  beats=beats, tokens_at_close=at_close - at_start)


def warm_arrivals(arrivals: List[Dict], chunk: int, vocab: int,
                  gap_s: float = 0.25) -> List[Dict]:
    """The warm-up trace: one request for each prefill shape the window's
    arrivals give (a one-shot length bucket, or a chunked prompt ending in
    each tail bucket), taken in turn from the shortest and the longest
    prompts of that shape, due ``gap_s`` apart so that each is prefilled
    on its own, with outputs at the quantiles of the arrivals' outputs up
    to their 75th percentile, so that the decode batches shrink as they
    finish. Eqs. 2 and 3, which the control plane refits from these
    iterations before the window, then see batches and contexts that vary
    apart: with one batch size, or contexts in proportion to the batch,
    Eq. 3's least squares is near singular, and a wild fit can make
    Algorithm 1 refuse every request on an idle cluster for good (PERF.md,
    Open questions). Token ids from a fixed generator: the same work for
    every seed, since every seed's arrivals hold the same lengths."""
    from pbcore import work
    rng = np.random.default_rng(12345)
    shapes = {}
    for s in sorted({a["l_in"] for a in arrivals}):
        plan = work.chunk_plan(s, chunk)
        tail = plan[-1][0] if plan else s
        bucket = max(8, 1 << (tail - 1).bit_length())
        shapes.setdefault((bool(plan), bucket), []).append(s)
    prompts = sorted(lens[-1] if i % 2 else lens[0]
                     for i, (_, lens) in enumerate(sorted(shapes.items())))
    k = len(prompts)
    outs = np.quantile([a["l_out"] for a in arrivals],
                       0.75 * (np.arange(k) + 0.5) / k)
    outs = [max(2, int(x)) for x in outs[::-1]]   # shortest prompt longest
    return [{"due_s": gap_s * i, "l_in": s, "l_out": o,
             "tokens": rng.integers(2, vocab, s)}
            for i, (s, o) in enumerate(zip(prompts, outs))]
