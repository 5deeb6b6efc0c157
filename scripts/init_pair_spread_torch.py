#!/usr/bin/env python3
"""Init-pair search of the PyTorch port, over many random seeds, on match
tables saved by ``chip_smoke.py --dump``.

    python scripts/init_pair_spread_torch.py tables.npz --seeds 32 [--device cpu]

The port's counterpart of ``scripts/init_pair_spread_jax.py``: for each
seed it runs ``rank_init_pairs`` and ``find_best_pair`` with a generator
seeded from that seed, and prints the chosen pair, its point count, the
path taken (essential or homography) and the relative pose's errors
against ground truth. Imports only the port.
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
    ap.add_argument("tables")
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--max-dim", type=float, default=512.0)
    ap.add_argument("--min-initial-inliers", type=int, default=100,
                    help="100 on the classical bench tables, 60 on the deep path's")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.sfm.matches import invert_matches
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, rank_init_pairs
    from eacham_tpu_torch.sfm.scene import make_scene
    from eacham_tpu_torch.sfm.twoview import find_best_pair
    from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg

    dev = resolve_device(args.device)
    # the bench's init options (bench.py; scripts/bench_deep.py lowers the inliers)
    opt = SfmOptions(min_initial_inliers=args.min_initial_inliers, init_min_tri_angle_deg=1.0,
                     ransac_hyps_e=256, ransac_hyps_h=128)
    d = np.load(args.tables)
    t = {k: torch.as_tensor(d[k], device=dev) for k in (
        "keypoints", "kp_mask", "pair_idx", "pair_ok", "match_ij", "valid_ij", "intr")}
    m_ji, v_ji = invert_matches(t["match_ij"], t["valid_ij"])
    scene = make_scene(t["keypoints"], t["kp_mask"], t["pair_idx"], t["pair_ok"],
                       t["match_ij"], t["valid_ij"], m_ji, v_ji, t["intr"])
    score = rank_init_pairs(scene, args.max_dim).cpu().numpy()
    order = np.argsort(-score)
    order = order[score[order] > 0]
    runs = []
    with torch.no_grad():
        for seed in range(args.seeds):
            gen = torch.Generator(device=dev).manual_seed(seed)
            row, init = find_best_pair(
                gen, scene, order, opt.min_initial_inliers, opt.init_max_repr_error,
                opt.init_min_tri_angle, chunk=opt.init_chunk,
                n_hyp_e=opt.ransac_hyps_e, n_hyp_h=opt.ransac_hyps_h)
            if row is None:
                runs.append({"seed": seed, "pair": None})
            else:
                i, j = (int(v) for v in d["pair_idx"][row])
                rot, trans = relative_pose_error_deg(init.T.cpu().numpy(),
                                                     d["poses"][i], d["poses"][j])
                runs.append({"seed": seed, "pair": [i, j], "n_good": int(init.n_good),
                             "homography": bool(init.used_homography),
                             "rot_deg": rot, "trans_deg": trans})
            print(json.dumps(runs[-1]), flush=True)
    found = [r for r in runs if r["pair"] is not None]
    for path, rs in (("E", [r for r in found if not r["homography"]]),
                     ("H", [r for r in found if r["homography"]])):
        if rs:
            print(f"port {path} path: {len(rs)}/{len(runs)} seeds, rotation error "
                  f"max {max(r['rot_deg'] for r in rs):.4f} deg, translation direction "
                  f"error {min(r['trans_deg'] for r in rs):.4f}-"
                  f"{max(r['trans_deg'] for r in rs):.4f} deg", flush=True)


if __name__ == "__main__":
    main()
