"""Spans: where the host's time inside a search goes, on the profiler's
clock.

``span(name)`` marks one stretch of host work at a layer boundary of the
search path (``SPANS`` names them all). While a ``torch.profiler`` records,
a span opens a profiler range under ``name``, so that it sits in the same
trace as the device's kernels and shares their clock, and it appends one
``Record`` to a bounded in-memory buffer. ``spans()`` returns the records of
the latest stretch recorded under the profiler: a span that opens while the
profiler records, after one was skipped while it did not, clears the buffer
first. While no profiler records, a span costs one check of the profiler's
state and returns one shared object that does nothing.

A record carries the id of its call: ``index.search_async`` mints one
(``mint=True``), which the search's token keeps (``current_call()``) and
passes to the spans of its ``wait``; every other span takes the id of the
span that encloses it on its thread, and records that span's name as its
parent.

``count(name, value, call)`` records one program counter's value for a
call (``COUNTERS`` names them all), under the same switch and in the same
stretch as the spans: a counter computed inside a captured program comes
back with the call's result, and its token records it in ``wait``. A
counter of the host's own work (``HOST_COUNTERS``: a flat rerun's, a
selector's copy to a device or its host evaluation) is recorded where the
work runs, under the enclosing span's call. ``counts()`` returns the
latest stretch's.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from time import perf_counter_ns
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

# every span the port opens, outermost first within each layer
SPANS = (
    "index.search_async",   # the whole enqueue of one call
    "index.prep_queries",   # queries padded into pinned memory, the upload
    "index.sel_stream",     # the selector's stream: its evaluation on the
                            # device, enqueued (a host one where it has no
                            # device form)
    "programs.capture",     # a miss: the eager warm-up and the capture
    "programs.replay",      # a hit: input copies, replay, output clones
    "token.wait",           # the whole wait
    "token.sync",           # the wait for this call's own work (traced only)
    "token.copy",           # the wait for the result's copy, its view
    "token.unpack",         # the result arrays
    "token.fallback",       # the rerun of the uncertified queries
    "fallback.tier1",       # a flat rerun on the two-plane sweep
    "fallback.tier2",       # a flat rerun on the plain path
    "ivf.coarse_gemm",      # the IVF gather search's stages
    "ivf.top_nprobe",
    "ivf.chunk_ids",
    "ivf.k10",
    "ivf.top_k",
    "ivf.norm_stream",      # the fine scan's norm stream, once a generation
)
# every program counter the port records
COUNTERS = (
    "ivf.live_chunks",      # the fine scan's budget positions that hold a
                            # probed list's chunk, over the call's queries
    "ivf.budget_chunks",    # its budget positions (nq_pad × chunk budget)
    "ivf.chunks_read",      # the distinct pool chunks K10 read
)
# every counter of the host's own work, recorded where the work runs
HOST_COUNTERS = (
    "flat.tier1_rows",      # a flat call's queries re-run on the two-plane
                            # sweep (by its wait)
    "flat.tier2_rows",      # and on the plain path
    "flat.reduced_pins",    # shapes pinned to the two-plane sweep
    "sel.uploads",          # a selector's ids or mask copied to a device
    "sel.host_evals",       # a selector evaluated on the host
)
# records kept: a profiler left on cannot grow the buffer without end
MAX_RECORDS = 1 << 17

# whether a profiler records (the one switch: there is no other)
recording = _profiler_enabled
# the fast range where this torch has it (about a tenth of
# record_function's cost under the profiler)
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


class Record(NamedTuple):
    name: str
    t0_ns: int              # time.perf_counter_ns() at the span's start
    t1_ns: int              # and at its end
    call: Optional[int]     # the call id, None outside a call
    parent: Optional[str]   # the enclosing span's name

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


class Count(NamedTuple):
    name: str
    value: int
    call: Optional[int]     # the call id, None outside a call


_records: deque = deque(maxlen=MAX_RECORDS)
_counts: deque = deque(maxlen=MAX_RECORDS)
_skipped = True             # a span was skipped since the last recorded one
_calls = itertools.count()
_local = threading.local()


class _Off:
    """The span while no profiler records. Its ``__enter__`` and
    ``__exit__`` are a builtin that takes any arguments and returns "" (a
    builtin does not bind to the instance, and "" is false, so an exception
    passes through): the ``with`` then runs no Python frame, about half the
    cost of a Python no-op on every untraced call."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


def _new_stretch() -> None:
    """The buffers start over at the first record after a skip."""
    global _skipped
    if _skipped:
        _skipped = False
        _records.clear()
        _counts.clear()


class _Span:
    __slots__ = ("name", "call", "parent", "stack", "range", "t0")

    def __init__(self, name: str, call: Optional[int]):
        self.name, self.call = name, call

    def __enter__(self):
        _new_stretch()
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        if stack:
            outer = stack[-1]
            self.parent = outer.name
            if self.call is None:
                self.call = outer.call
        else:
            self.parent = None
        self.stack = stack
        stack.append(self)
        self.range = _range(self.name)
        self.range.__enter__()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        self.range.__exit__(*exc)
        self.stack.pop()
        # a plain tuple here, a Record when read: the cost stays off the
        # traced calls
        _records.append((self.name, self.t0, t1, self.call, self.parent))
        return False


def span(name: str, call: Optional[int] = None, *, mint: bool = False):
    """A context manager around one stretch of host work: a profiler range
    and a record while a profiler records, else nothing. ``call``: the call
    id to record (a token's wait passes its call's); ``mint``: a new one
    (each ``search_async``); otherwise the enclosing span's."""
    global _skipped
    if not recording():
        _skipped = True
        return _OFF
    return _Span(name, next(_calls) if mint else call)


def count(name: str, value: int, call: Optional[int] = None) -> None:
    """Record a counter's ``value`` (``COUNTERS``, ``HOST_COUNTERS``) for
    the call ``call`` while a profiler records; else nothing."""
    if recording():
        _new_stretch()
        _counts.append((name, int(value), call))


def current_call() -> Optional[int]:
    """The call id of the innermost span open on this thread, None where
    none is open (always, while no profiler records)."""
    stack = getattr(_local, "stack", None)
    return stack[-1].call if stack else None


def spans() -> List[Record]:
    """The records of the latest stretch recorded under the profiler, in
    the order the spans ended (at most ``MAX_RECORDS``, the newest)."""
    return [Record._make(r) for r in list(_records)]


def counts() -> List[Count]:
    """The counter records of the latest stretch recorded under the
    profiler, in the order they were recorded."""
    return [Count._make(c) for c in list(_counts)]
