#!/usr/bin/env python3
"""The JAX package's ``run_sfm`` on a deep world's match tables saved by
``chip_smoke.py --dump-deep``, on the CPU.

    JAX_PLATFORMS=cpu python scripts/deep_sfm_replay_jax.py tables.npz [--seed 0] [--seeds 1]

The tables are the port's: ``build_match_tables_deep``'s 6-tuple
(windowed and retrieval pairs, epipolar-verified) with the keypoints and
ground-truth poses of one world of ``scripts/bench_deep.py``'s recipe. This
runs the reference's two-view search (``rank_init_pairs`` and
``find_best_pair`` with the key ``run_sfm`` derives from ``--seed`` on a
6-tuple) and its ``run_sfm(match_tables=...)`` with the recipe's options,
and prints one JSON line a seed: registered frames, landmarks, ATE (camera centres
after a similarity alignment, as ``scripts/bench_deep.py`` measures it),
the init pair and its rotation / translation-direction error, seconds, and
the port's figures saved with the tables. ``scripts/deep_sfm_replay_torch.py``
does the same with the port, so both packages can be held to identical
tables. Imports only the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# scripts/bench_deep.py:76-85
DEEP_OPTIONS = dict(
    min_initial_inliers=60, min_matches=20, match_ratio=0.85,
    init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=16384, refine_max_iters=30, global_max_iters=50,
    local_ba_every=3)
TABLES = ("pair_idx", "pair_ok", "match_ij", "valid_ij", "match_ji", "valid_ji")


def pose_error_deg(T_rel, T_i, T_j):
    T_gt = T_j.astype(np.float64) @ np.linalg.inv(T_i.astype(np.float64))
    dR = np.asarray(T_rel, np.float64)[:3, :3] @ T_gt[:3, :3].T
    rot = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    a = T_rel[:3, 3] / np.linalg.norm(T_rel[:3, 3])
    b = T_gt[:3, 3] / np.linalg.norm(T_gt[:3, 3])
    return float(rot), float(np.degrees(np.arccos(np.clip(a @ b, -1, 1))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tables")
    ap.add_argument("--seed", type=int, default=0, help="SfmOptions.seed (the first of --seeds)")
    ap.add_argument("--seeds", type=int, default=1, help="run seeds seed..seed+seeds-1")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from eacham_tpu.sfm.pipeline import SfmOptions, rank_init_pairs, run_sfm
    from eacham_tpu.sfm.scene import make_scene
    from eacham_tpu.sfm.twoview import find_best_pair
    from eacham_tpu.utils.evaluate import ate_rmse

    d = np.load(args.tables)
    xy, mask, poses, intr = d["keypoints"], d["kp_mask"], d["poses"], d["intr"]
    tables = tuple(jnp.asarray(d[k]) for k in TABLES)
    N, K = mask.shape
    W, H = int(round(2 * intr[2])), int(round(2 * intr[3]))
    for seed in range(args.seed, args.seed + args.seeds):
        opt = SfmOptions(seed=seed, **DEEP_OPTIONS)
        # the two-view stage as run_sfm runs it on a 6-tuple (no verification key)
        scene0 = make_scene(jnp.asarray(xy), jnp.asarray(mask), *tables, jnp.asarray(intr),
                            lm_capacity=opt.lm_capacity)
        score = np.asarray(rank_init_pairs(scene0, float(max(W, H))))
        order = np.argsort(-score)
        order = order[score[order] > 0]
        _, k_init = jax.random.split(jax.random.PRNGKey(seed))
        row, init = find_best_pair(
            k_init, scene0, order, opt.min_initial_inliers, opt.init_max_repr_error,
            opt.init_min_tri_angle, chunk=opt.init_chunk,
            n_hyp_e=opt.ransac_hyps_e, n_hyp_h=opt.ransac_hyps_h)
        init_rec = {"init_pair": None}
        if row is not None:
            i, j = (int(v) for v in d["pair_idx"][row])
            rot, trans = pose_error_deg(np.asarray(init.T), poses[i], poses[j])
            init_rec = {"init_pair": [i, j], "init_rot_deg": rot, "init_trans_deg": trans,
                        "n_good": int(init.n_good),
                        "used_homography": bool(init.used_homography)}

        t0 = time.perf_counter()
        scene, stats = run_sfm(jnp.asarray(xy), jnp.zeros((N, K, 1), jnp.float32),
                               jnp.asarray(mask), image_size=(W, H), intr=jnp.asarray(intr),
                               options=opt, verbose=False, match_tables=tables)
        valid = np.asarray(scene.pose_valid)
        est = np.asarray(scene.pose)[valid]
        gt = poses[valid]
        ce = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
        cg = -np.einsum("nij,ni->nj", gt[:, :3, :3], gt[:, :3, 3])
        rec = {"package": "jax", "tables": args.tables, "world": int(d["world"]),
               "seed": seed, "registered": int(stats["registered"]),
               "landmarks": int(stats.get("landmarks", 0)),
               "ate": float(ate_rmse(ce, cg)), **init_rec,
               "run_sfm_init_pair": (list(stats["init_pair"]) if stats.get("init_pair")
                                     else None),
               "seconds": time.perf_counter() - t0,
               "port_registered": int(d["port_registered"]), "port_ate": float(d["port_ate"]),
               "port_init_pair": [int(v) for v in d["port_init_pair"]]}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
