#!/usr/bin/env python3
"""The readings that a cell's limits are set from (not run by the benchmark).

    python3 sfmbench/control.py --workload <name> --seeds 1,2,3

In one process, after the cell's set-up and warm-up: for each seed one
request through the timed path at the cell's own size (a whole
reconstruction of the closed loop, or a whole stream of the open loop at
the cell's rate), judged twice by the plain reference: as the program
produced it (the lower readings), with the configuration's control in
the program's place (the reference one precision below, or with a stated
guarantee broken: the upper readings), and with each of ``FAULTS`` planted
in what the program produced (the readings of a number that no control
moves), and point_gain at other firmness than ``geometry.POINT_FIRM``
(the readings it was chosen from). One JSON line a seed: every set of
numbers and the request's seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _pairs_halved(out):
    """Every other candidate pair left out of the program's pair list (its
    row made padding), as if the matcher saw half the graph."""
    sc = dict(out["scene"])
    real = (sc["pair_idx"][:, 0] < sc["pair_idx"][:, 1]).nonzero()[:, 0]
    pi = sc["pair_idx"].clone()
    pi[real[1::2]] = 0
    sc["pair_idx"] = pi
    return dict(out, scene=sc)


def _matches_halved(out):
    """Every other match of the program's match graph dropped."""
    sc = dict(out["scene"])
    v = sc["valid_ij"].clone()
    on = v.reshape(-1).nonzero()[:, 0]
    v.view(-1)[on[1::2]] = False
    sc["valid_ij"] = v
    return dict(out, scene=sc)


FAULTS = {"pairs_halved": _pairs_halved, "matches_halved": _matches_halved}
FIRMS = (3.0, 10.0, 30.0, 100.0)


def readings(workload: str, seeds: list[int], device=None, here: Path | None = None,
             emit=print) -> list[dict]:
    import numpy as np

    from sfmbench import harness
    from sfmbench.entry import Program
    from sfmbench.reference.judge import judge_map, worst_readings
    from sfmbench.run import card

    here = here or harness.HERE
    c = harness.cell(workload, here=here)
    dev = device if device is not None else card(c["workload"]["chips"])
    t = c["traffic"]
    spec = harness.check_spec(c)
    inputs = harness.make_inputs(c["config"], here=here)
    truth = {"images": inputs.get("images"), "poses": inputs["poses"], "intr": inputs["intr"]}
    rows = []
    for i, seed in enumerate(seeds):
        prog = Program(c["config"], t, inputs, seed, dev, c["frontend"])
        if i == 0:
            prog.build()
            (prog.warmup_closed if t["mode"] == "closed" else prog.warmup_open)()
        t0 = time.perf_counter()
        if t["mode"] == "closed":
            out = prog.reconstruct(0)["out"]
        else:
            st = []
            harness.drive_open(lambda s: st.append(prog.stream(s)) or st[-1], 0.0,
                               t["rate_fps"], t["chunk"], t["stream_frames"])
            out = st[0].out
        row = {"workload": workload, "seed": seed, "request_s": time.perf_counter() - t0}
        for name, control in (("program", None), ("control", c["config"]["control"])):
            rng = np.random.default_rng(harness.sample_seed(seed))
            row[name] = worst_readings([out], truth, spec, rng, control)
        for name, plant in FAULTS.items():
            rng = np.random.default_rng(harness.sample_seed(seed))
            row[name] = worst_readings([plant(out)], truth, spec, rng)
        ctl = c["config"]["control"].get("points")
        row["point_gain_by_firm"] = {
            name: {str(f): judge_map(out["scene"], points_control=pc, firm=f)["point_gain"]
                   for f in FIRMS} for name, pc in (("program", None), ("control", ctl))}
        emit(json.dumps(row))
        rows.append(row)
    return rows


def main() -> int:
    sys.path[0] = str(ROOT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    args = ap.parse_args()
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
