#!/usr/bin/env python3
"""Where the port's slices spend their time on the card, in steady state.

    python scripts/profile_slice_torch.py [--frontend classical|deep] [--full]
                                          [--runs 3] [--trace trace.json]

Renders the 100-frame bench workload (as ``chip_smoke.py``), runs the
chosen path once to warm up (``extract_features`` -> ``initialize_sfm``,
or with ``--frontend deep`` ``extract_deep_batch`` ->
``build_match_tables_deep`` -> ``initialize_sfm(match_tables=...)`` on the
shipped weights, at ``chip_smoke.py``'s sizes and options; with ``--full``
the whole path, ``extract_features`` -> ``run_sfm`` at the bench's options
or, with ``--frontend deep``, the deep front half -> ``run_sfm`` at
``scripts/bench_deep.py``'s, with the sweep's and the finalization's seconds
beside the front half's), then ``--runs``
more times with stage timings, the last of them under ``torch.profiler``.
Prints the card, the steady-state stage seconds of every timed run, the
device-busy share of the profiled run (device time summed over all
kernels and copies, over its wall time), and the device time by kernel.
The profiled run's split comes from the port's own spans
(``eacham_tpu_torch.utils.timer``, recorded while the profiler runs): calls,
seconds, self seconds, host waits for the card (the count ``readbacks``)
and the sum of every other count (``registered``, ``pnp_failed``,
``iterations``) of each span name, then the device's idle seconds by the
innermost span open at each gap, on the profiler's clock (the span names
the stage that kept the card waiting; "(no span)": between the program's
calls). With ``--full`` the profiled run's launches are also given per
registered frame. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def slice_once(images, intr, dev):
    import torch

    from chip_smoke import BENCH_OPTIONS, HEIGHT, MAX_KPS, WIDTH
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, initialize_sfm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xy, desc, _, mask = extract_features(images, max_keypoints=MAX_KPS, device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    _, stats = initialize_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                              options=SfmOptions(**BENCH_OPTIONS), device=dev)
    torch.cuda.synchronize()
    return dict(extract=t_extract, **stats["seconds"],
                total=time.perf_counter() - t0), stats


def full_once(images, intr, dev):
    import torch

    from chip_smoke import BENCH_OPTIONS, HEIGHT, MAX_KPS, WIDTH
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xy, desc, _, mask = extract_features(images, max_keypoints=MAX_KPS, device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    _, stats = run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                       options=SfmOptions(**BENCH_OPTIONS), device=dev)
    torch.cuda.synchronize()
    return dict(extract=t_extract, **stats["seconds"],
                total=time.perf_counter() - t0), stats


def deep_full_once(images, intr, dev, models):
    import torch

    from chip_smoke import DEEP_OPTIONS, HEIGHT, WIDTH, deep_front
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm

    t0 = time.perf_counter()
    xy, desc, mask, tables, t_extract, t_match = deep_front(models, images, intr, dev)
    _, stats = run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                       options=SfmOptions(**DEEP_OPTIONS), device=dev, match_tables=tables)
    torch.cuda.synchronize()
    return dict(extract_deep=t_extract, match_deep=t_match, **stats["seconds"],
                total=time.perf_counter() - t0), stats


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals of ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def span_rows(recs: list) -> dict:
    """Per name of the closed span records ``recs``: calls, seconds, self
    seconds (a span's time less what its children cover) and the sum of
    each count."""
    from collections import Counter, defaultdict

    closed = [i for i, r in enumerate(recs) if r["end_ns"] is not None]
    kids = defaultdict(list)
    for i in closed:
        if recs[i]["parent"] is not None:
            kids[recs[i]["parent"]].append((recs[i]["start_ns"], recs[i]["end_ns"]))
    rows = {}
    for i in closed:
        r = recs[i]
        t0, t1 = r["start_ns"], r["end_ns"]
        covered = sum(max(0, min(b, t1) - max(a, t0)) for a, b in union(kids[i]))
        row = rows.setdefault(r["name"], {"calls": 0, "seconds": 0.0, "self": 0.0,
                                          "counts": Counter()})
        row["calls"] += 1
        row["seconds"] += (t1 - t0) / 1e9
        row["self"] += (t1 - t0 - covered) / 1e9
        row["counts"].update(r["counts"])
    return rows


def idle_by_span(recs: list, busy: list, m0: int, m1: int) -> dict:
    """Seconds of device idle time in [m0, m1] (ns on the profiler's clock)
    by the name of the innermost closed span open at each gap's midpoint
    (None: outside every span). ``busy``: the merged, sorted device
    intervals."""
    import bisect
    from collections import defaultdict

    gaps, prev = [], m0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, min(a, m1)))
        prev = max(prev, b)
    if m1 > prev:
        gaps.append((prev, m1))
    # the timeline cut where any span starts or ends, and the innermost span
    # open over each piece
    closed = [i for i, r in enumerate(recs) if r["end_ns"] is not None]
    marks = sorted([(recs[i]["start_ns"], 1, i) for i in closed]
                   + [(recs[i]["end_ns"], 0, i) for i in closed])
    starts, inner, stack = [], [], []
    for t, opens, i in marks:
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        inner.append(stack[-1] if stack else None)
    out = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        k = bisect.bisect_right(starts, (a + b) / 2) - 1
        best = inner[k] if k >= 0 else None
        out[None if best is None else recs[best]["name"]] += (b - a) / 1e9
    return dict(out)


def span_split(busy: list, m0: int, m1: int, card: str) -> None:
    """Print the profiled run's spans by name, and the device's idle time in
    [m0, m1] (``busy``: its merged busy intervals) by the innermost span
    open at each gap."""
    from eacham_tpu_torch.utils import timer

    recs = timer.records()
    print(f"spans of the profiled run on {card} (calls, seconds, self seconds, host "
          "waits, other counts summed):", flush=True)
    rows = span_rows(recs)
    for name, row in sorted(rows.items(), key=lambda kv: -kv[1]["self"]):
        counts = dict(row["counts"])
        waits = counts.pop("readbacks", 0)
        print(f"  {name:36s} {row['calls']:6d} {row['seconds']:9.4f} {row['self']:9.4f} "
              f"{waits:7d}  " + " ".join(f"{k} {v}" for k, v in sorted(counts.items())),
              flush=True)
    idle = idle_by_span(recs, busy, m0, m1)
    total = sum(idle.values())
    named = total - idle.get(None, 0.0)
    print(f"device idle by innermost span: {total:.4f} s of {(m1 - m0) / 1e9:.4f}, "
          f"{100 * named / max(total, 1e-12):.2f}% under a named span:", flush=True)
    for name, t in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name or '(no span)':36s} {t:9.4f} {100 * t / max(total, 1e-12):6.2f}%",
              flush=True)


def deep_once(images, intr, dev, models):
    from chip_smoke import deep_stages

    out = deep_stages(models, images, intr, dev)
    return out[-1], out[5]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frontend", choices=("classical", "deep"), default="classical")
    ap.add_argument("--full", action="store_true",
                    help="the whole path (features -> run_sfm)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="also write a Chrome trace of the profiled run")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, render_workload
    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.utils import timer

    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    images, _, intr = render_workload()
    images = torch.as_tensor(images, device=dev)
    once = full_once if args.full else slice_once
    if args.frontend == "deep":
        from functools import partial

        from eacham_tpu_torch.features.deep.frontend import load_frontend_params

        once = partial(deep_full_once if args.full else deep_once,
                       models=load_frontend_params(device=dev)[:2])
    secs, _ = once(images, intr, dev)
    print("warm-up (s): " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()), flush=True)
    for r in range(args.runs):
        if r < args.runs - 1:
            secs, stats = once(images, intr, dev)
        else:
            timer.clear()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                m0 = time.time_ns()          # the profiler's clock
                secs, stats = once(images, intr, dev)
                m1 = time.time_ns()
        print(f"run {r} (s){' under the profiler' if r == args.runs - 1 else ''} "
              f"on {card}: " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
              + f"; init pair {stats['init_pair']}"
              + (f", registered {stats['registered']}, landmarks {stats['landmarks']}, "
                 f"global BA {stats['global_ba']}" if args.full else ""), flush=True)

    # kernels and copies only: an operator's device time repeats its kernels',
    # and the device-side copies of the spans' annotations are no work
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    busy = union((e.start_ns(), e.start_ns() + e.duration_ns()) for e in kernels)
    busy_s = sum(b - a for a, b in busy) / 1e9
    print(f"profiled run: wall {secs['total']:.4f} s, device busy {busy_s:.4f} s "
          f"({len(kernels)} kernels and copies), idle share "
          f"{1 - busy_s / secs['total']:.4f}"
          + (f"; {len(kernels) / stats['registered']:.1f} kernels and copies a registered "
             "frame" if args.full else ""), flush=True)
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (t + e.duration_ns(), n + 1)
    print(f"device time by kernel, top {args.top} (ms, launches):", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {t / 1e6:10.3f}  {n:6d}  {name[:110]}", flush=True)
    span_split(busy, m0, m1, card)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
