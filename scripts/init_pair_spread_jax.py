#!/usr/bin/env python3
"""Init-pair search of the JAX package, over many random seeds, on match
tables saved by ``chip_smoke.py --dump``.

    JAX_PLATFORMS=cpu python scripts/init_pair_spread_jax.py tables.npz --seeds 32

For each seed it runs ``rank_init_pairs`` and ``find_best_pair`` with the
keys ``run_sfm`` derives from that seed, and prints the chosen pair, its
point count, whether the homography path was taken, and the relative
pose's rotation and translation-direction errors against ground truth.
``scripts/init_pair_spread_torch.py`` does the same with the PyTorch port;
the two together show how far the reference's two-view stage itself
spreads on the same tables. Imports only the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pose_error_deg(T_rel, T_i, T_j):
    T_gt = T_j.astype(np.float64) @ np.linalg.inv(T_i.astype(np.float64))
    dR = T_rel[:3, :3].astype(np.float64) @ T_gt[:3, :3].T
    rot = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    a = T_rel[:3, 3] / np.linalg.norm(T_rel[:3, 3])
    b = T_gt[:3, 3] / np.linalg.norm(T_gt[:3, 3])
    return float(rot), float(np.degrees(np.arccos(np.clip(a @ b, -1, 1))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tables")
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--max-dim", type=float, default=512.0)
    ap.add_argument("--min-initial-inliers", type=int, default=100,
                    help="100 on the classical bench tables, 60 on the deep path's")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from eacham_tpu.sfm.matches import invert_matches
    from eacham_tpu.sfm.pipeline import SfmOptions, rank_init_pairs
    from eacham_tpu.sfm.scene import make_scene
    from eacham_tpu.sfm.twoview import find_best_pair

    # the bench's init options (bench.py; scripts/bench_deep.py lowers the inliers)
    opt = SfmOptions(min_initial_inliers=args.min_initial_inliers, init_min_tri_angle_deg=1.0,
                     ransac_hyps_e=256, ransac_hyps_h=128)
    d = np.load(args.tables)
    m_ji, v_ji = invert_matches(jnp.asarray(d["match_ij"]), jnp.asarray(d["valid_ij"]))
    scene = make_scene(*(jnp.asarray(d[k]) for k in (
        "keypoints", "kp_mask", "pair_idx", "pair_ok", "match_ij", "valid_ij")),
        m_ji, v_ji, jnp.asarray(d["intr"]))
    score = np.asarray(rank_init_pairs(scene, args.max_dim))
    order = np.argsort(-score)
    order = order[score[order] > 0]
    runs = []
    for seed in range(args.seeds):
        key = jax.random.PRNGKey(seed)
        key, _ = jax.random.split(key)          # run_sfm's verification key
        key, k_init = jax.random.split(key)
        row, init = find_best_pair(
            k_init, scene, order, opt.min_initial_inliers, opt.init_max_repr_error,
            opt.init_min_tri_angle, chunk=opt.init_chunk,
            n_hyp_e=opt.ransac_hyps_e, n_hyp_h=opt.ransac_hyps_h)
        if row is None:
            runs.append({"seed": seed, "pair": None})
        else:
            i, j = (int(v) for v in d["pair_idx"][row])
            rot, trans = pose_error_deg(np.asarray(init.T), d["poses"][i], d["poses"][j])
            runs.append({"seed": seed, "pair": [i, j], "n_good": int(init.n_good),
                         "homography": bool(init.used_homography),
                         "rot_deg": rot, "trans_deg": trans})
        print(json.dumps(runs[-1]), flush=True)
    found = [r for r in runs if r["pair"] is not None]
    for path, rs in (("E", [r for r in found if not r["homography"]]),
                     ("H", [r for r in found if r["homography"]])):
        if rs:
            print(f"jax {path} path: {len(rs)}/{len(runs)} seeds, rotation error "
                  f"max {max(r['rot_deg'] for r in rs):.4f} deg, translation direction "
                  f"error {min(r['trans_deg'] for r in rs):.4f}-"
                  f"{max(r['trans_deg'] for r in rs):.4f} deg", flush=True)


if __name__ == "__main__":
    main()
