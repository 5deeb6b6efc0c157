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
With ``--full`` one more run times the sweep's and the finalization's
building blocks (next-best-view, PnP, triangulation, window build, BA,
pruning) under synchronized timers (calls, seconds, ms a call), and the
profiled run's launches are also given per registered frame. Needs a CUDA
card.
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


def sweep_components(images, intr, dev, once=full_once):
    """One more full run with the sweep's and the finalization's building
    blocks wrapped in synchronized timers: {name: (calls, seconds)}. The
    synchronizations stop the host from running ahead, so the sum is an
    upper bound of what the blocks cost inside an untimed run."""
    import torch

    from eacham_tpu_torch.sfm import device_loop, pipeline

    totals = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            calls, secs = totals.get(name, (0, 0.0))
            totals[name] = (calls + 1, secs + time.perf_counter() - t0)
            return out
        return wrapper

    patched = [(device_loop, "next_best_view"), (device_loop, "pnp_register"),
               (device_loop, "triangulate_frame"), (device_loop, "local_neighbors"),
               (device_loop, "ba_problem_windowed"), (device_loop, "refine_ba"),
               (pipeline, "prune_observations"), (pipeline, "ba_problem_windowed"),
               (pipeline, "refine_ba_sharded")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]
    try:
        for mod, name, fn in saved:
            where = "sweep" if mod is device_loop else "finalize"
            setattr(mod, name, timed(f"{where}.{name}", fn))
        secs, _ = once(images, intr, dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return totals, secs


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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                secs, stats = once(images, intr, dev)
        print(f"run {r} (s){' under the profiler' if r == args.runs - 1 else ''} "
              f"on {card}: " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
              + f"; init pair {stats['init_pair']}"
              + (f", registered {stats['registered']}, landmarks {stats['landmarks']}, "
                 f"global BA {stats['global_ba']}" if args.full else ""), flush=True)

    if args.full:
        totals, secs_c = sweep_components(images, intr, dev, once)
        print(f"building blocks under synchronized timers on {card} (that run: sweep "
              f"{secs_c['sweep']:.4f} s, finalize {secs_c['finalize']:.4f} s); calls, seconds, "
              "ms a call:", flush=True)
        for name, (calls, t) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
            print(f"  {name:32s} {calls:6d} {t:9.4f} {1e3 * t / calls:9.3f}", flush=True)

    # kernels and copies only: an operator's device time repeats its kernels'
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                       # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_s = busy_us / 1e6
    print(f"profiled run: wall {secs['total']:.4f} s, device busy {busy_s:.4f} s "
          f"({len(kernels)} kernels and copies), idle share "
          f"{1 - busy_s / secs['total']:.4f}"
          + (f"; {len(kernels) / stats['registered']:.1f} kernels and copies a registered "
             "frame" if args.full else ""), flush=True)
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"device time by kernel, top {args.top} (ms, launches):", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {t / 1e3:10.3f}  {n:6d}  {name[:110]}", flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
