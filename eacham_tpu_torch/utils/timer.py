"""The port's span-and-counter recorder, and wall-clock stage timing with
accumulated statistics (``BlockTimer``, port of eacham_tpu/utils/timer.py).

``span(name, **attrs)`` is a context manager around one piece of work. It
always measures its host duration (``.seconds``, on ``time.perf_counter``);
while a torch profiler is running it also enters
``torch.autograd.profiler.record_function(name)``, so that the span appears
as a user annotation among the profiler's events, and keeps a record:

    {"name", "start_ns", "end_ns", "parent", "root", "attrs", "counts"}

``start_ns`` / ``end_ns`` are on the profiler's clock (the epoch clock,
``time.time_ns``), read just outside the annotation; ``parent`` is the index in
``records()`` of the enclosing span of the same thread (None for a root);
``root`` numbers the root spans, one a request; ``counts`` are what
``span.add`` and ``add`` added while the span was the innermost one open.
With no profiler running a span costs one flag read, one flag write and
its two clock reads, and nothing is recorded. No span synchronizes the
device: where a span ends at a read-back the card's catching up lies inside
it.

The records are kept until ``clear()``, or until a new profiler session
begins: when a root span opens under a profiler and some span has run with
no profiler since the last record was made, the old records are dropped
first. So ``records()`` holds the latest session's spans (two sessions with
no span run between them stay in one list, each request its own ``root``).

The count ``readbacks`` is the host's waits for the card at a transfer:
each read of device values (``readback``), and each host value written to
the card from pageable memory (a Python scalar or list: counted with
``add`` where it is written).

``BlockTimer`` is the reference's RAII timer + static accumulation
(modules/base/tools/BlockTimer.cpp:10-47) on top of ``span``: host-visible
stage latency, timed to the stage's end on the card only where the stage
ends in a read back to the host or a ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch.autograd.profiler as _prof

_STATS: dict[str, list[float]] = defaultdict(list)


class _Recorder:
    """The records of the spans entered while a profiler ran, and each
    thread's stack of open recorded spans."""

    def __init__(self):
        self.records: list[dict] = []
        self.roots = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()
        self.stale = False      # a span ran with no profiler since the last record

    def stack(self) -> list[int]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str, attrs: dict) -> dict:
        st = self.stack()
        if self.stale and not st:
            clear()
            st = self.stack()
        parent = st[-1] if st else None
        rec = {"name": name, "start_ns": None, "end_ns": None, "parent": parent,
               "root": self.records[parent]["root"] if st else next(self.roots),
               "attrs": attrs, "counts": {}}
        with self.lock:
            st.append(len(self.records))
            self.records.append(rec)
        return rec

    def close(self, rec: dict) -> None:
        st = self.stack()
        if st and self.records[st[-1]] is rec:
            st.pop()


_REC = _Recorder()


class span:
    """``with span(name, **attrs) as s:`` times the block (``s.seconds``)
    and, while a profiler runs, records it (see the module docstring);
    ``s.add(counter, n)`` adds to one of its counts."""

    __slots__ = ("name", "attrs", "seconds", "_t0", "_rec", "_fn")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.seconds = 0.0
        self._rec = None

    def __enter__(self):
        if _prof._is_profiler_enabled:
            self._rec = _REC.open(self.name, self.attrs)
            self._rec["start_ns"] = time.time_ns()
            self._fn = _prof.record_function(self.name)
            self._fn.__enter__()
        else:
            _REC.stale = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._rec is not None:
            self._fn.__exit__(*exc)
            self._rec["end_ns"] = time.time_ns()
            _REC.close(self._rec)
            self._fn = None
        return False

    def add(self, counter: str, n: int = 1) -> None:
        if self._rec is not None:
            c = self._rec["counts"]
            c[counter] = c.get(counter, 0) + n


def add(counter: str, n: int = 1) -> None:
    """Add ``n`` to ``counter`` on this thread's innermost recorded span
    (nothing while no profiler runs)."""
    if _prof._is_profiler_enabled:
        st = _REC.stack()
        if st:
            c = _REC.records[st[-1]]["counts"]
            c[counter] = c.get(counter, 0) + n


def readback(read, *args, **kwargs):
    """``read(*args, **kwargs)``: a transfer that makes the host wait for
    the card (a read of device values, or an upload from pageable memory),
    counted as ``readbacks`` 1 on the innermost recorded span."""
    add("readbacks")
    return read(*args, **kwargs)


def records() -> list[dict]:
    """The records kept since the last ``clear`` or the start of the latest
    profiler session (see the module docstring; a span still open has
    ``end_ns`` None)."""
    return _REC.records


def clear() -> None:
    """Drop the records (the spans open on this thread stay open, unrecorded)."""
    _REC.records = []
    _REC.local = threading.local()
    _REC.stale = False


@contextmanager
def BlockTimer(caption: str, accumulate: bool = True, verbose: bool = False):
    s = span(caption)
    try:
        with s:
            yield
    finally:
        ms = s.seconds * 1e3
        if accumulate:
            _STATS[caption].append(ms)
        if verbose:
            print(f"[{caption}] time: {ms:.2f} ms", flush=True)


def print_stats() -> None:
    """Count + mean per caption (BlockTimer::PrintStat, BlockTimer.cpp:38-47)."""
    for caption, xs in _STATS.items():
        print(
            f"[{caption}] count: {len(xs)}, mean: {sum(xs) / len(xs):.2f} ms",
            flush=True,
        )


def stats() -> dict[str, list[float]]:
    """Milliseconds recorded per caption since the last ``reset_stats``."""
    return {caption: list(xs) for caption, xs in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()
