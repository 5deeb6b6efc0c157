#!/usr/bin/env python3
"""The ``rgbd`` and ``stereo`` recipes of ``chip_smoke.py`` on the JAX
package (the reference), on the CPU: the figures the port's phases are set
beside.

    JAX_PLATFORMS=cpu python scripts/rgbd_reference_jax.py [--frames 100]
        [--phase rgbd|stereo|both] [--seed 0] [--pnp-seeds 0,1,2] [--out DIR]

``rgbd``: 100 frames of the bench's blob world rendered at TUM RGB-D's
640x480 with its nominal intrinsics, depth from ``scripts/rgbd_recipe.py``
with 1% noise, written as a TUM directory under ``--out``, read back with
``TumDataset`` -> ``extract_features(K=1024)`` -> ``depth_at_keypoints`` ->
``run_sfm_rgbd`` with the bench's options (``lm_capacity`` N*K).
``stereo``: the bench's 100 frames (512x384, K=512) as left views, right
views 0.1 m along each camera's x axis, one ``match_pair`` per frame, the
row and disparity filter, ``stereo_depth_at_keypoints`` -> ``run_sfm_rgbd``.
Each phase prints one JSON line for each ``--pnp-seeds`` entry (the
``SfmOptions.seed`` of the PnP draws; the features are extracted once):
registered frames, landmarks, the metric ATE (ground truth in frame 0's
gauge, nothing fitted) and stage seconds (host clock, CPU; compile time
included in the first calls).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import rgbd_recipe as R  # noqa: E402

# bench.py's options (chip_smoke.py BENCH_OPTIONS), the landmark capacity
# left at the metric pipeline's default N * K
OPTIONS = dict(
    min_initial_inliers=100, min_matches=25, match_ratio=0.85,
    init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=None, refine_max_iters=30, global_max_iters=50,
    match_chunk=32, local_ba_every=4)
BENCH_SIZE, BENCH_KPS, RGBD_KPS = (512, 384), 512, 1024


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _runs(tag, pnp_seeds, xy, desc, mask, kp_z, intr, gt_w2c, base):
    """One ``run_sfm_rgbd`` a PnP seed; yields each run's record."""
    import dataclasses

    import jax.numpy as jnp

    from eacham_tpu.sfm.pipeline import SfmOptions
    from eacham_tpu.sfm.rgbd import run_sfm_rgbd

    for ps in pnp_seeds:
        t = time.perf_counter()
        scene, stats = run_sfm_rgbd(xy, desc, mask, kp_z, jnp.asarray(intr),
                                    options=dataclasses.replace(SfmOptions(**OPTIONS), seed=ps),
                                    verbose=False)
        _block(scene.pose)
        secs = dict(base["seconds"], run_sfm_rgbd=time.perf_counter() - t)
        valid = np.asarray(scene.pose_valid)
        yield {**base, "phase": tag, "pnp_seed": ps, "registered": stats["registered"],
               "landmarks": stats["landmarks"],
               "metric_ate": R.metric_ate(np.asarray(scene.pose), gt_w2c, valid),
               "seconds": secs}


def run_rgbd(n, seed, out, pnp_seeds):
    import jax.numpy as jnp

    from eacham_tpu.features.frontend import extract_features
    from eacham_tpu.io.datasets import TumDataset
    from eacham_tpu.sfm.rgbd import depth_at_keypoints
    from eacham_tpu.utils.synthetic import make_blob_scene, orbit_poses, render_view

    W, H = R.TUM_SIZE
    blobs = make_blob_scene(np.random.default_rng(seed), **R.BLOBS)
    poses = orbit_poses(n, **R.ORBIT)
    images = np.stack([render_view(blobs, T, R.TUM_INTR, W, H) for T in poses])
    depths = np.stack([R.noisy_depth(R.render_depth(blobs, T, R.TUM_INTR, W, H), i)
                       for i, T in enumerate(poses)])
    R.write_tum(out, images, depths, poses)
    secs = {}
    t = time.perf_counter()
    ds = TumDataset.open(out)
    batch = ds.load()
    depth, has = ds.load_depth()
    gt_c2w, gt_ok = ds.gt_for_frames()
    secs["load"] = time.perf_counter() - t
    t = time.perf_counter()
    xy, desc, _, mask = _block(extract_features(jnp.asarray(batch.images),
                                                max_keypoints=RGBD_KPS))
    secs["extract"] = time.perf_counter() - t
    t = time.perf_counter()
    kp_z = _block(depth_at_keypoints(jnp.asarray(depth), xy))
    secs["depth"] = time.perf_counter() - t
    base = {"package": "eacham_tpu", "frames": n, "max_keypoints": RGBD_KPS,
            "depth_frames": int(has.sum()), "gt_frames": int(gt_ok.sum()), "seconds": secs}
    yield from _runs("rgbd", pnp_seeds, xy, desc, mask, kp_z, R.TUM_INTR,
                     np.linalg.inv(gt_c2w), base)


def run_stereo(n, seed, pnp_seeds):
    import jax.numpy as jnp

    from eacham_tpu.features.frontend import extract_features
    from eacham_tpu.features.matching import match_pair
    from eacham_tpu.sfm.rgbd import stereo_depth_at_keypoints
    from eacham_tpu.utils.synthetic import make_blob_scene, orbit_poses, render_view

    W, H = BENCH_SIZE
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = make_blob_scene(np.random.default_rng(seed), **R.BLOBS)
    poses = orbit_poses(n, **R.ORBIT)
    left = np.stack([render_view(blobs, T, intr, W, H) for T in poses])
    right = np.stack([render_view(blobs, R.right_pose(T), intr, W, H) for T in poses])
    secs = {}
    t = time.perf_counter()
    xy, desc, _, mask = _block(extract_features(jnp.asarray(left), max_keypoints=BENCH_KPS))
    xr, dr, _, mr = _block(extract_features(jnp.asarray(right), max_keypoints=BENCH_KPS))
    secs["extract"] = time.perf_counter() - t
    t = time.perf_counter()
    right_x = np.zeros(mask.shape, np.float32)
    keep = np.zeros(mask.shape, bool)
    xy_np, xr_np = np.asarray(xy), np.asarray(xr)
    for i in range(n):
        j, v = match_pair(desc[i], dr[i], mask[i], mr[i], ratio=OPTIONS["match_ratio"])
        j, v = np.asarray(j), np.asarray(v)
        keep[i] = R.stereo_keep(xy_np[i], xr_np[i][j], v)
        right_x[i] = xr_np[i][j][:, 0]
    secs["stereo_match"] = time.perf_counter() - t
    kp_z = stereo_depth_at_keypoints(xy, jnp.asarray(right_x), jnp.asarray(intr),
                                     R.STEREO_BASELINE) * jnp.asarray(keep)
    base = {"package": "eacham_tpu", "frames": n, "max_keypoints": BENCH_KPS,
            "stereo_matches_per_frame": float(keep.sum(1).mean()), "seconds": secs}
    yield from _runs("stereo", pnp_seeds, xy, desc, mask, kp_z, intr, poses, base)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=R.N_FRAMES)
    ap.add_argument("--phase", choices=["rgbd", "stereo", "both"], default="both")
    ap.add_argument("--seed", type=int, default=0, help="the world's seed")
    ap.add_argument("--pnp-seeds", default="0",
                    help="comma-separated SfmOptions.seed values, one run each")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "rgbd_reference"))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    pnp_seeds = [int(v) for v in args.pnp_seeds.split(",")]
    runs = []
    if args.phase in ("rgbd", "both"):
        runs.append(run_rgbd(args.frames, args.seed, Path(args.out), pnp_seeds))
    if args.phase in ("stereo", "both"):
        runs.append(run_stereo(args.frames, args.seed, pnp_seeds))
    for records in runs:
        for rec in records:
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
