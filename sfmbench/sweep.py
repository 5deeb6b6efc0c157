#!/usr/bin/env python3
"""The rate sweep that an open-loop cell's ``rate_fps`` is chosen from (not
run by the benchmark).

    python3 sfmbench/sweep.py --workload <name> --rates 6,9,12 [--streams 2]

In one process, after the cell's set-up and warm-up: for each rate,
``--streams`` streams back to back on one schedule, as the cell's window
runs them. One JSON line a rate: the frame latency's median and 95th
percentile, the backlog at the first and the last chunk, and each
chunk's span. The highest rate the system sustains is the highest whose
backlog does not grow over the streams.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path[0] = str(ROOT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--streams", type=int, default=2)
    args = ap.parse_args()

    import numpy as np

    from sfmbench import harness
    from sfmbench.entry import Program
    from sfmbench.run import card

    c = harness.cell(args.workload)
    t = c["traffic"]
    dev = card(c["workload"]["chips"])
    inputs = harness.make_inputs(c["config"])
    prog = Program(c["config"], t, inputs, 1, dev, c["frontend"])
    prog.build()
    prog.warmup_open()
    for rate in (float(r) for r in args.rates.split(",")):
        seconds = (args.streams - 0.5) * t["stream_frames"] / rate
        out = harness.drive_open(prog.stream, seconds, rate, t["chunk"], t["stream_frames"])
        lat, failed = harness.frame_latencies(out)
        ch = out["chunks"]
        print(json.dumps({
            "rate_fps": rate, "streams": out["streams"], "frames": len(lat), "failed": failed,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "backlog_first_s": ch[0]["backlog"], "backlog_last_s": ch[-1]["backlog"],
            "backlog_max_s": max(x["backlog"] for x in ch),
            "span_s": [round(x["span_s"], 4) for x in ch]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
