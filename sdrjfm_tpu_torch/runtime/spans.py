"""The port's tracer: spans and counters, recorded inside the process.

A span is one record (`Span`): its name, its start and end in
`time.monotonic_ns()`, the span that was open around it (its parent, by
sequence number, -1 at the top), the id of the pass or block it works for
(its parent's unless given), an optional count (the blocks, frames or
bytes it covers, -1 none), and whether a profiler was recording when it
began.  Spans nest through a stack of open spans (one a thread).  A closed
span goes into a preallocated ring of `CAPACITY` records; the oldest are
overwritten, so the record stays bounded however long a run goes.  A
stamp (`stamp`) is a record of zero length at a time taken elsewhere: the
live sources stamp `source.arrival`, when the ring received a block's last
frame.

The hot paths record always: two clock reads and one store a span, a few
spans a pass or a block and none a graph replay.  While `torch.profiler`
records, a span is also a `record_function` range of the same name, so
the spans sit in the profiler's trace on its device events' clock; with
no profiler the one check costs tens of nanoseconds and no range is
entered.

Clock: `time.monotonic_ns()` reads CLOCK_MONOTONIC, the clock that
`std::chrono::steady_clock` reads on Linux, so the ingest thread's stamps
(`runtime/native/ringbuffer.h`) subtract from spans with no conversion.

Counters are plain integers by name (`counters`, `count`):
`kernel.builds` (nvcc and g++ runs), `graph.captures` (CUDA graphs
captured), `scan.stage_ranges` (the scan runners' staging ranges,
`ScanGraph.load_blocks`), `scan.stage_overlapped` (those of them, after a
chunk's first, whose staging began while the card still had the previous
range's replays queued; always 0 on the CPU), `scan.fetch_pinned`
(`ScanGraph.fetch`es whose outputs came down into pinned memory) and
`scan.fetch_host_allocs` (the pinned blocks those fetches had to allocate,
from `torch.cuda.host_memory_stats()`; both always 0 on the CPU).
`records()` reads the record out; `write_json(path)` writes it with the
counters (`rx --profile DIR` writes `spans_<pid>.json`).
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple

import torch

# A 30 s window of scan passes (69 records a 32-block pass staged a block a
# range, ~52,000 at 40 ms a pass) or of live blocks whole, with the set-up's
# spans before it.
CAPACITY = 1 << 17

_clock = time.monotonic_ns
_profiling = torch._C._autograd._profiler_enabled      # a profiler records


class Span(NamedTuple):
    seq: int
    name: str
    t0: int                   # ns, CLOCK_MONOTONIC
    t1: int
    parent: int               # seq of the enclosing span, -1 at the top
    id: int                   # the pass or block, -1 none
    count: int                # blocks, frames or bytes, -1 none
    profiled: bool            # a profiler recorded when it began

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


_ring: List[tuple] = [None] * CAPACITY
_seq = itertools.count()
_open = threading.local()
counters: Dict[str, int] = {"kernel.builds": 0, "graph.captures": 0,
                            "scan.stage_ranges": 0,
                            "scan.stage_overlapped": 0,
                            "scan.fetch_pinned": 0,
                            "scan.fetch_host_allocs": 0}


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


class span:
    """`with span(name, id=-1, count=-1) as s:` records one span around
    the block; `s.count` may be set inside it, and `s.t0`, `s.t1` read
    after it (ns)."""

    __slots__ = ("name", "id", "count", "seq", "parent", "t0", "t1", "_rf")

    def __init__(self, name: str, id: int = -1, count: int = -1):
        self.name, self.id, self.count = name, id, count

    def __enter__(self) -> "span":
        st = _stack()
        if st:
            top = st[-1]
            self.parent = top.seq
            if self.id < 0:
                self.id = top.id
        else:
            self.parent = -1
        self.seq = next(_seq)
        st.append(self)
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = _clock()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _stack().pop()
        _ring[self.seq % CAPACITY] = (self.seq, self.name, self.t0, self.t1,
                                      self.parent, self.id, self.count,
                                      self._rf is not None)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def traced(name: str):
    """A decorator: each call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            with span(name):
                return fn(*a, **k)
        return call
    return wrap


def stamp(name: str, t_ns: int, count: int = -1) -> None:
    """A record of zero length at `t_ns` (CLOCK_MONOTONIC ns), a child of
    the open span."""
    st = _stack()
    top = st[-1] if st else None
    seq = next(_seq)
    _ring[seq % CAPACITY] = (seq, name, t_ns, t_ns,
                             top.seq if top else -1, top.id if top else -1,
                             count, _profiling())


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


def records() -> List[Span]:
    """The spans and stamps in the ring, in the order they began."""
    return [Span(*r) for r in sorted(r for r in _ring if r is not None)]


def clear() -> None:
    """Empty the ring (the counters stay)."""
    _ring[:] = [None] * CAPACITY


def write_json(path: str) -> str:
    """The record and the counters as one JSON object in `path`."""
    doc = {"clock": "CLOCK_MONOTONIC", "unit": "ns", "pid": os.getpid(),
           "capacity": CAPACITY, "counters": dict(counters),
           "spans": [r._asdict() for r in records()]}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
