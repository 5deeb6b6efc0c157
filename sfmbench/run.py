#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print one JSON line.

    python3 sfmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build or load, the inputs made from the
seed, a warm-up on a prefix of the cell's own inputs), then a window of
``--seconds`` under the cell's traffic, then the plain reference's check of
what the window produced. With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics; with ``--trace 1`` one request of the window runs
under the profiler and the metrics are the cell's per-layer ones.

Needs an NVIDIA card: without one (or with fewer than the cell asks for)
it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "eacham_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card(chips: int):
    """The card to run on; raises SystemExit without enough of them."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sfmbench: no CUDA device; the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"sfmbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        here: Path | None = None, t_start: float = T_START) -> dict:
    """One run; returns the result line's object. ``device`` None means the
    card (``card``); tests pass the CPU and a copy of this folder."""
    import numpy as np
    import torch

    from sfmbench import harness
    from sfmbench.entry import Program, sync

    here = here or harness.HERE
    c = harness.cell(workload, here=here)
    dev = device if device is not None else card(c["workload"]["chips"])
    inputs = harness.make_inputs(c["config"], here=here)
    prog = Program(c["config"], c["traffic"], inputs, seed, dev, c["frontend"])
    build = prog.build()
    t = c["traffic"]
    mode = t["mode"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ctx = {"workload": c["workload"], "config": c["config"], "traffic": t,
           "requests": [], "stream": None, "trace": None}
    if mode == "closed":
        prog.warmup_closed()
        sync(dev)
        ctx["setup_s"] = time.perf_counter() - t_start

        def once(k):
            return prog.reconstruct(k, profile=trace and k == 1)

        out = harness.drive_closed(once, seconds, need=2 if trace else 1)
        ctx["requests"] = out["records"]
        ctx["window_s"] = out["window_s"]
        traced = [r for r in out["records"] if r["profiled"]]
        if traced:
            ctx["trace"] = traced[0]["trace"]
            ctx["traced_request"] = traced[0]
        judged = [r["out"] for r in out["records"]]
        attempted = sum(r["frames"] for r in out["records"])
        failed = sum(r["frames"] - r["registered"] for r in out["records"])
    elif mode == "open":
        prog.warmup_open()
        sync(dev)
        ctx["setup_s"] = time.perf_counter() - t_start
        n_streams = harness.open_streams(seconds, t["rate_fps"], t["stream_frames"])
        streams = []

        def new_stream(s):
            streams.append(prog.stream(s, profile=trace and s == n_streams - 1))
            return streams[-1]

        out = harness.drive_open(new_stream, seconds, t["rate_fps"], t["chunk"],
                                 t["stream_frames"])
        lat, failed = harness.frame_latencies(out)
        ctx["stream"] = {"latencies": lat, "failed": failed, "chunks": out["chunks"],
                         "streams": out["streams"]}
        ctx["window_s"] = out["window_s"]
        traced = [s for s in streams if s.session is not None]
        if traced:
            ctx["trace"] = traced[0].session.trace
        judged = [s.out for s in streams]
        attempted = len(lat)
    else:
        raise harness.CellError(f"traffic mode {mode!r} is neither 'closed' nor 'open'")

    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        v = c["readers"][m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the window has closed: judge what it produced
    rng = np.random.default_rng(harness.sample_seed(seed))
    truth = {"images": inputs.get("images"), "poses": inputs["poses"], "intr": inputs["intr"]}
    spec = harness.check_spec(c)
    checks = judge_all(judged, truth, spec, rng, c["limits"])
    correct = passes(checks)

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": c["workload"]["chips"], "memory_peak_bytes": peak}}
    if trace and ctx["trace"] is not None:
        from sfmbench.devtrace import breakdown

        result["device"]["busy_s"] = ctx["trace"]["busy_s"]
        result["device"]["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = breakdown(ctx["trace"])
    result["diagnostics"] = diagnostics(ctx, build)
    result["checks"] = checks
    return result


def judge_all(judged, truth, spec, rng, limits) -> dict:
    """The worst reading over the requests judged of each number that the
    cell's limits file names, beside its limit (a number that is not
    finite, NaN included, reads None and fails). Without a limits file
    every number is shown with the limit None, and fails."""
    import math

    from sfmbench.reference.judge import worst_readings

    worst = worst_readings(judged, truth, spec, rng)
    lim = limits if limits else {k: None for k in worst}
    return {k: {"value": worst[k] if math.isfinite(worst.get(k, math.nan)) else None,
                "limit": lim[k]} for k in lim}


def passes(checks: dict) -> bool:
    return bool(checks) and all(c["value"] is not None and c["limit"] is not None
                                and c["value"] <= c["limit"] for c in checks.values())


def diagnostics(ctx, build) -> dict:
    """What the window did besides its metrics (not read by any check)."""
    d = {"setup_s": ctx["setup_s"], "window_s": ctx["window_s"],
         "built": {k: not v["cached"] for k, v in build.items()}}
    if ctx["requests"]:
        d["requests"] = [{"k": r["k"], "total_s": r["total_s"], "registered": r["registered"],
                          "profiled": r["profiled"],
                          "seconds": {k: round(v, 4) for k, v in r["seconds"].items()}}
                         for r in ctx["requests"]]
    if ctx["stream"]:
        ch = ctx["stream"]["chunks"]
        d["streams"] = ctx["stream"]["streams"]
        d["chunk_span_s"] = [round(c["span_s"], 4) for c in ch]
        d["backlog_max_s"] = max(c["backlog"] for c in ch)
        d["backlog_last_s"] = ch[-1]["backlog"]
        d["generator_late_max_s"] = max(c["late"] for c in ch)
    return d


def main(argv=None) -> int:
    sys.path[0] = str(ROOT)          # the checkout's root, not this folder
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"sfmbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
