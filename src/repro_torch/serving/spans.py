"""Spans of the live serving path, kept in memory.

One process-wide ``RECORDER`` (as the kernels keep process-wide
``launches`` counters) records a span at the boundaries of
``ServingCluster`` and ``PagedEngine``: its name, its start and end, the
index of the enclosing span that caused it (or -1), and the id of the
request it concerns (or -1). A zero-length span is an instant.

The clock is ``time.perf_counter``, read by the recorder itself: the
clock a device trace can be tied to by a marker kernel launched right
after a host read of it, so program spans and device operations share one
timeline. The recorder never calls a cluster's or an engine's ``time_fn``,
whose reads are the reference's, one for one.

The newest ``capacity`` records are kept in a ring; ``dropped`` counts the
ones overwritten. ``enabled = False`` turns recording off, and each site
then costs a call and one attribute test. Records belong to the one
thread that serves.
"""
from __future__ import annotations

import functools
import math
from time import perf_counter
from typing import Callable, List, NamedTuple, Optional


class Span(NamedTuple):
    index: int       # order of beginning, counted from 0 in the process
    name: str
    t0: float        # perf_counter seconds
    t1: float        # nan while the span is open
    parent: int      # index of the enclosing span, or -1
    rid: int         # the request's id, or -1


class SpanRecorder:
    def __init__(self, capacity: int = 1 << 16):
        self.enabled = True
        self.capacity = capacity
        self.recorded = 0                      # records ever begun
        self._ring: List[Optional[list]] = [None] * capacity
        self._open: List[int] = []             # indices of the open spans

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.capacity)

    def begin(self, name: str, rid: int = -1) -> int:
        """Open a span inside the innermost open one; returns its index
        for ``end`` (-1 while disabled)."""
        if not self.enabled:
            return -1
        i = self.recorded
        self.recorded = i + 1
        op = self._open
        rec = [name, 0.0, math.nan, op[-1] if op else -1, rid]
        self._ring[i % self.capacity] = rec
        op.append(i)
        rec[1] = perf_counter()
        return i

    def end(self, i: int) -> None:
        """Close span ``i`` and any span opened inside it that an
        exception left open."""
        if i < 0:
            return
        t = perf_counter()
        if self.recorded - i <= self.capacity:
            self._ring[i % self.capacity][2] = t
        op = self._open
        while op and op.pop() != i:
            pass

    def instant(self, name: str, rid: int = -1) -> None:
        if not self.enabled:
            return
        op = self._open
        t = perf_counter()
        self._ring[self.recorded % self.capacity] = [
            name, t, t, op[-1] if op else -1, rid]
        self.recorded += 1

    def traced(self, name: str) -> Callable:
        """Decorator: each call of the function is one span."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                i = self.begin(name)
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.end(i)
            return call
        return wrap

    def spans(self) -> List[Span]:
        """The kept records, in the order they began."""
        lo = self.recorded - min(self.recorded, self.capacity)
        return [Span(i, *self._ring[i % self.capacity])
                for i in range(lo, self.recorded)]


RECORDER = SpanRecorder()
