"""A profiled request, reduced to what the per-layer readers and the
result line's ``breakdown`` take: device busy time, kernel counts, device
time by kernel name, and idle gaps by what the host was doing.

Nothing is written to disk: the profiler's raw events are read in memory
(``kineto_results``) and dropped.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

MARK = "sfmbench.request"
COPIES = ("memcpy", "memset")


def union(spans):
    """Merged, sorted (start, end) intervals of ``spans``."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def reduce_events(events) -> dict:
    """Reduce raw profiler events (objects with ``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``, ``start_thread_id()``) to seconds and
    counts inside the marker's interval."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name() == MARK and e.device_type() == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the profiler recorded no request marker")
    m0 = marks[0].start_ns()
    m1 = m0 + marks[0].duration_ns()
    thread = marks[0].start_thread_id()
    device, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= m0 or a >= m1 or e.name() == MARK or getattr(e, "is_user_annotation", bool)():
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((max(a, m0), min(b, m1), e.name()))
        elif e.start_thread_id() == thread and e.name() != MARK:
            host.append((a, b, e.name()))
    busy = union((a, b) for a, b, _ in device)
    by_name = defaultdict(lambda: [0.0, 0])
    kernels = 0
    for a, b, n in device:
        by_name[n][0] += (b - a) / 1e9
        by_name[n][1] += 1
        kernels += not n.lower().startswith(COPIES)
    return {"window_s": (m1 - m0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "kernels": kernels, "device_events": len(device),
            "by_name": {n: (t, c) for n, (t, c) in by_name.items()},
            "idle_gaps": idle_by_host(busy, host, m0, m1)}


def outermost(host):
    """The host operations that no other one on the thread encloses."""
    top, end = [], -1
    for a, b, n in sorted(host, key=lambda x: (x[0], -x[1])):
        if a >= end:
            top.append((a, b, n))
            end = b
    return top


def idle_by_host(busy, host, m0, m1) -> dict:
    """Seconds of device idle time by the outermost host operation running
    at each gap's midpoint ("python" where none was: the interpreter's own
    work between calls)."""
    top = outermost(host)
    starts = [a for a, _, _ in top]
    gaps = []
    prev = m0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if m1 > prev:
        gaps.append((prev, m1))
    out = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = top[i][2] if i >= 0 and top[i][1] > mid else "python"
        out[name] += (b - a) / 1e9
    return dict(out)


def breakdown(trace: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time, and the longest idle time by host operation."""
    ops = sorted(((n, t) for n, (t, _) in trace["by_name"].items()), key=lambda x: -x[1])
    gaps = sorted(trace["idle_gaps"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:120], t] for n, t in ops[:top]],
            "idle_gaps": [[n[:120], t] for n, t in gaps[:top]]}


class Session:
    """A ``torch.profiler`` session (host, and the card where there is one)
    around a marker, spanning any number of calls: ``start()`` before the
    first, ``stop()`` after the last (the card synchronized), then
    ``trace``. It opens with four fill kernels, which take the places of a
    session's first device records: those can be lost."""

    def __init__(self, device):
        self.device = device
        self.trace = None
        self._prof = self._mark = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        for _ in range(4):
            torch.ones(1024, device=self.device)
        self._sync()
        self._mark = record_function(MARK)
        self._mark.__enter__()

    def stop(self):
        self._sync()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.trace = reduce_events(self._prof.profiler.kineto_results.events())
        self._prof = self._mark = None
