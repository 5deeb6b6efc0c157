#!/usr/bin/env python3
"""The port's ``run_sfm`` on a deep world's match tables saved by
``chip_smoke.py --dump-deep``, on the card or with ``--device cpu``.

    python scripts/deep_sfm_replay_torch.py tables.npz [--seed 0] [--device cpu]

The counterpart of ``scripts/deep_sfm_replay_jax.py``: the same tables
(``build_match_tables_deep``'s 6-tuple, keypoints and ground truth of one
world of ``scripts/bench_deep.py``'s recipe), ``run_sfm(match_tables=...)``
with the recipe's options, and one JSON line with the same keys: registered
frames, landmarks, ATE, the init pair and its rotation / translation-
direction error, seconds, the device, and the figures saved with the
tables. The RANSAC draws of the two packages are not comparable, so a
difference of one seed says little; ``--seeds`` runs several.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TABLES = ("pair_idx", "pair_ok", "match_ij", "valid_ij", "match_ji", "valid_ji")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tables")
    ap.add_argument("--seed", type=int, default=0, help="SfmOptions.seed (the first of --seeds)")
    ap.add_argument("--seeds", type=int, default=1, help="run seeds seed..seed+seeds-1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from chip_smoke import DEEP_OPTIONS      # scripts/bench_deep.py:76-85
    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg, trajectory_ate

    dev = resolve_device(args.device)
    d = np.load(args.tables)
    xy, mask, poses, intr = d["keypoints"], d["kp_mask"], d["poses"], d["intr"]
    tables = tuple(torch.as_tensor(d[k], device=dev) for k in TABLES)
    N, K = mask.shape
    W, H = int(round(2 * intr[2])), int(round(2 * intr[3]))
    for seed in range(args.seed, args.seed + args.seeds):
        t0 = time.perf_counter()
        scene, stats = run_sfm(xy, np.zeros((N, K, 1), np.float32), mask, image_size=(W, H),
                               intr=intr, options=SfmOptions(seed=seed, **DEEP_OPTIONS),
                               match_tables=tables, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"package": "torch", "device": str(dev), "tables": args.tables,
               "world": int(d["world"]), "seed": seed, "registered": stats["registered"],
               "landmarks": stats["landmarks"], "init_pair": None}
        if stats["initialized"]:
            valid = scene.pose_valid.cpu().numpy()
            i, j = stats["init_pair"]
            rot, trans = relative_pose_error_deg(stats["T_init"].cpu().numpy(), poses[i],
                                                 poses[j])
            rec.update(ate=trajectory_ate(scene.pose.cpu().numpy()[valid], poses[valid]),
                       init_pair=[i, j], init_rot_deg=rot, init_trans_deg=trans,
                       n_good=stats["n_good"], used_homography=stats["used_homography"],
                       global_ba=stats["global_ba"])
        rec.update(seconds=time.perf_counter() - t0,
                   port_registered=int(d["port_registered"]), port_ate=float(d["port_ate"]),
                   port_init_pair=[int(v) for v in d["port_init_pair"]])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
