"""Request lifecycle shared by the scheduler, engine and simulator."""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Optional

_ids = itertools.count()


class ReqState(str, enum.Enum):
    QUEUED = "queued"          # arrived, not yet placed
    PLACED = "placed"          # assigned to a worker, waiting for prefill
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"          # worker died; will be re-queued


@dataclasses.dataclass
class Request:
    l_in: int                              # prompt length (known on arrival)
    l_pred: int                            # predicted output length
    l_real: int = 0                        # ground-truth output (sim/engine)
    arrival: float = 0.0
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: ReqState = ReqState.QUEUED
    worker: Optional[int] = None
    # progress
    l_out: int = 0                         # tokens generated so far
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    t_decode_spent: float = 0.0            # decode wall time so far
    t_prefill_start: Optional[float] = None
    repredicted: bool = False              # Alg. 2: re-predicted after overrun
    tokens: Optional[object] = None        # actual token ids (engine only)
    # spot-preemption recovery: the worker serving this request was reclaimed
    # mid-flight, its KV was lost, and the request re-entered the queue. The
    # generated-token count (l_out) is retained — recovery re-prefills the
    # prompt AND the tokens generated so far — and the stall from reclaim to
    # re-prefill completion is charged against the ATGT clock.
    preempt_count: int = 0                 # times reclaimed mid-flight
    t_preempted: Optional[float] = None    # pending reclaim stall start
    # multi-tenant serving: which TenantSpec this request belongs to (index
    # into Scenario.tenants), its admission priority (higher places first),
    # and its tenant's own SLO budgets. ``inf`` budgets mean "untagged":
    # every constraint falls back to the scenario-level planning SLO, so a
    # legacy scalar-SLO trace is arithmetically untouched by the tenant
    # plumbing.
    tenant: int = 0
    priority: int = 0
    slo_ttft: float = math.inf             # tenant TTFT budget, seconds
    slo_atgt: float = math.inf             # tenant ATGT budget, s/token
    # multi-turn sessions: which conversation this request is a turn of
    # (``-1`` = a single-shot request outside any session), its turn index,
    # and the cacheable-prefix potential — the previous turn's full context
    # (prompt + generated), which a worker holding that KV can skip
    # re-prefilling. ``cached_len`` is the *granted* reuse: stamped at
    # placement from the chosen worker's prefix cache, consumed by the
    # first prefill, and zeroed on any requeue/move (the grant is only
    # valid on the worker that holds the blocks). All four default to the
    # neutral values, so single-shot traces are arithmetically untouched.
    session_id: int = -1
    turn: int = 0
    prefix_len: int = 0                    # cacheable prefix, tokens
    cached_len: int = 0                    # granted prefix reuse, tokens

    # ---- derived ------------------------------------------------------------
    @property
    def deadline(self) -> float:
        """Absolute EDF deadline (arrival + tenant TTFT budget); ordering
        key only — constraints use the relative ``slo_ttft`` budget so the
        float image of a single-tenant run matches the scalar path."""
        return self.arrival + self.slo_ttft

    @property
    def context(self) -> int:
        """Current context length (prompt + generated)."""
        return self.l_in + self.l_out

    @property
    def remaining_pred(self) -> int:
        return max(self.l_pred - self.l_out, 0)

    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    def atgt(self) -> Optional[float]:
        """Average token-generation time over the decode phase (§2.2)."""
        if self.t_finish is None or self.l_real <= 1:
            return None
        return self.t_decode_spent / max(self.l_real - 1, 1)

    def slo_ok(self, slo) -> bool:
        t1, t2 = self.ttft(), self.atgt()
        ok = True
        if t1 is not None:
            ok &= t1 <= slo.ttft
        if t2 is not None:
            ok &= t2 <= slo.atgt
        return ok
