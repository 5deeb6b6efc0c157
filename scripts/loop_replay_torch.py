#!/usr/bin/env python3
"""The port's loop solvers on loop measurements saved by
``chip_smoke.py --dump-loop``.

    python scripts/loop_replay_torch.py loop.npz [--compare jax_out.npz] [--device cpu]

The port's counterpart of ``scripts/loop_replay_jax.py``: from the finished
scene's poses and from the drifted ones the dump holds, runs
``optimize_pose_graph`` and ``submap_align`` and prints each result's loop
consistency and ATE against ground truth; ``--compare`` also prints the
largest difference from the JAX package's results on the same dump.
Imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--compare")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import torch

    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.sfm.posegraph import loop_consistency, optimize_pose_graph
    from eacham_tpu_torch.sfm.submap import submap_align
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    dev = resolve_device(args.device)
    d = np.load(args.dump)
    valid, fixed, gt = d["pose_valid"], d["pose_fixed"], d["gt"]
    lm = (d["pair_idx"], d["rows"], d["T_loop"], d["w_loop"])
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    ref = np.load(args.compare) if args.compare else None
    rec = {}
    for start in ("pose", "drifted"):
        P = d[start]
        pg = optimize_pose_graph(
            t(P), t(valid), t(fixed), t(d["pair_idx"]), t(d["T_meas"]), t(d["w_meas"]),
            iters=int(d["pgo_iters"]), loop_rows=t(d["rows"]), T_loop=t(d["T_loop"]),
            w_loop=t(d["w_loop"])).cpu().numpy()
        sub = submap_align(P, valid, fixed, *lm[:2], d["T_loop"], d["w_loop"],
                           size=int(d["submap_size"]))
        rec[start] = {"consistency_deg": {"input": loop_consistency(P, *lm),
                                          "pose_graph": loop_consistency(pg, *lm),
                                          "submap": loop_consistency(sub, *lm)},
                      "ate": {k: trajectory_ate(v[valid], gt[valid])
                              for k, v in (("input", P), ("pose_graph", pg), ("submap", sub))}}
        if ref is not None:
            rec[start]["max_abs_diff_from_jax"] = {
                "pose_graph": float(np.abs(pg - ref[f"{start}_pose_graph"]).max()),
                "submap": float(np.abs(sub - ref[f"{start}_submap"]).max())}
    print(json.dumps({"package": "eacham_tpu_torch", "device": str(dev), "from": rec}))


if __name__ == "__main__":
    main()
