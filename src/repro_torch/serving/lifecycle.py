"""The one condemn/kill/reap worker-lifecycle state machine.

Every worker container in the engine — the static colocated fleet
(``simulator.FixedPool``), both static disaggregated sides
(``disagg.FixedPrefillSide`` / ``disagg.FixedDecodeSide``) and the
policy-scaled ``forecast.ManagedPool`` — faces the same three questions when
a spot market reclaims capacity:

  * **condemn** — with a preemption notice, a victim stops taking new work
    and drains until ``t + notice_s``;
  * **kill** — without a notice (or at the notice deadline), the victim
    dies now: its in-flight requests are extracted, stamped with their
    recovery cost class, and handed back to the queue;
  * **reap** — each beat, condemned workers that drained empty retire
    cleanly (``drained_ok``), the rest are killed once their deadline
    passes.

Those transitions used to be four near-identical copies, each wired to its
container's innards. :class:`WorkerLifecycle` is that machine written once,
parameterized by what genuinely differs per container:

  ``extract(w)``   strip and return the worker's in-flight requests
  ``mark(r, t)``   stamp the recovery cost class on one lost request
                   (``mark_kv_loss`` for decode-capable workers whose KV
                   dies with them, ``mark_requeue`` for prefill queues)
  ``idle(w)``      is the worker empty (safe to retire)
  ``remove(w)``    physically take the worker out of its container
                   (including any retirement-cost accounting)
  ``on_condemn(w)`` flag the worker as draining so placement avoids it

The victim-selection RNG discipline (one ``rng.choice`` over the eligible
pool per event) and the counter semantics (``killed`` / ``drained_ok`` /
``requeued``) are part of the machine, so every container reports reclaim
accounting identically — tests/test_lifecycle_property.py fuzzes the same
interleavings through all four call sites.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.request import ReqState, Request


def mark_kv_loss(r: Request, t: float) -> None:
    """Default reclaim marking: the victim's KV is gone — the request
    requeues keeping ``l_out`` and pays a full context re-prefill plus the
    stall from the reclaim instant (settled by the simulator core)."""
    r.state = ReqState.QUEUED
    r.worker = None
    r.t_preempted = t
    r.preempt_count += 1


def mark_requeue(r: Request, t: float) -> None:
    """Prefill-side reclaim marking: no KV existed yet, so the only cost is
    the extra queue wait — which TTFT already measures (no ``t_preempted``
    stall is armed; the token stream has not started)."""
    r.state = ReqState.QUEUED
    r.worker = None
    r.preempt_count += 1


class WorkerLifecycle:
    """Condemn/kill/reap state machine shared by every worker container.

    Owns the condemned set (worker id -> notice deadline) and the reclaim
    counters; container-specific behavior enters only through the adapter
    callables described in the module docstring."""

    def __init__(self, rng, *, notice_s: float = 0.0,
                 extract: Callable[[object], List[Request]],
                 mark: Callable[[Request, float], None],
                 idle: Callable[[object], bool],
                 remove: Callable[[object], None],
                 on_condemn: Optional[Callable[[object], None]] = None):
        self.rng = rng
        self.notice_s = notice_s
        self._extract = extract
        self._mark = mark
        self._idle = idle
        self._remove = remove
        self._on_condemn = on_condemn or (lambda w: None)
        self.condemned: Dict[int, float] = {}     # wid -> kill deadline
        self.killed = 0
        self.drained_ok = 0
        self.requeued = 0

    # ---- victim selection ---------------------------------------------------
    def eligible(self, workers: Sequence) -> List:
        """The workers a market event may take: spot-priced and not already
        condemned by an earlier event (the provider is taking those back
        regardless — they are not fresh capacity)."""
        return [w for w in workers
                if w.spec.is_spot and w.id not in self.condemned]

    def reclaim(self, t: float, ev, candidates: Sequence,
                boots: Sequence = (),
                cancel_boot: Optional[Callable] = None) -> List[Request]:
        """One market reclaim event: take ``ceil(ev.frac * alive)`` victims
        (at least one) uniformly from ``candidates`` plus any ``boots``
        (still-booting workers, which die by cancellation — they never held
        requests). Without a notice window victims are killed on the spot;
        with one they are condemned to drain. Returns the requests knocked
        back into the queue."""
        alive = len(candidates) + len(boots)
        if alive == 0:
            return []
        n_kill = min(max(int(math.ceil(ev.frac * alive)), 1), alive)
        victims = self.rng.choice(alive, size=n_kill, replace=False)
        lost_all: List[Request] = []
        for vi in victims:
            if vi < len(candidates):
                w = candidates[vi]
                if self.notice_s > 0.0:
                    self.condemn(w, t)
                else:
                    lost_all += self.kill(w, t)
            else:
                cancel_boot(boots[vi - len(candidates)])
        return lost_all

    # ---- transitions --------------------------------------------------------
    def condemn(self, w, t: float) -> None:
        """Preemption notice: the worker drains (no new admissions) until
        ``t + notice_s``; whatever still runs at the deadline is killed."""
        self._on_condemn(w)
        self.condemned[w.id] = t + self.notice_s

    def kill(self, w, t: float) -> List[Request]:
        """The worker dies now: extract its in-flight requests, stamp each
        with the recovery cost class, and remove it from the container."""
        self.condemned.pop(w.id, None)
        lost = self._extract(w)
        self._remove(w)
        for r in lost:
            self._mark(r, t)
        self.killed += 1
        self.requeued += len(lost)
        return lost

    def retire_if_idle(self, w) -> bool:
        """Retire a draining worker that emptied out; counted ``drained_ok``
        only when it was inside a notice window (voluntary scale-down drains
        retire silently)."""
        if not self._idle(w):
            return False
        self._remove(w)
        if self.condemned.pop(w.id, None) is not None:
            self.drained_ok += 1
        return True

    def reap(self, t: float, lookup: Callable[[int], Optional[object]],
             retire_idle: bool = True) -> List[Request]:
        """Per-beat pass over the condemned set: workers that drained empty
        retire (when ``retire_idle``; containers with their own drain
        retirement — ManagedPool's end-of-beat — pass False), workers past
        their deadline are killed. ``lookup(wid)`` resolves a condemned id
        to the live worker, or None when it already retired."""
        lost_all: List[Request] = []
        for wid, deadline in list(self.condemned.items()):
            w = lookup(wid)
            if w is None:                 # already retired as drained_ok
                self.condemned.pop(wid, None)
                continue
            if retire_idle and self.retire_if_idle(w):
                continue
            if t >= deadline:
                lost_all += self.kill(w, t)
        return lost_all
