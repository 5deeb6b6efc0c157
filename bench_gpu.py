#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: end-to-end SfM throughput (frames/s)
on one NVIDIA card.

    python3 bench_gpu.py [--seed 0]

``bench.py``'s workload on ``eacham_tpu_torch``: IMAGES IN -> REGISTERED
POSES OUT. A 100-frame synthetic orbit (512x384) is rendered, untimed, with
exact ground truth; the timed region runs the whole pipeline as a user
would call it:

  1. ``features.frontend.extract_features`` on the image batch (K = 512);
  2. ``sfm.pipeline.run_sfm``: exhaustive pair matching with epipolar
     verification, init pair, incremental PnP / triangulation / local-BA
     sweep, pruning and global BA.

A warm-up pass comes first (it builds the CUDA kernel and fills PyTorch's
allocator and cuDNN's plan caches), then the timed pass; both end in
``torch.cuda.synchronize()``. The run is correctness-gated like
``bench.py``: at least 95 of the 100 frames registered and an ATE under 0.1
against ground truth, or it fails.

Prints the card's name and power limit, one ``#`` line per pass, and last
ONE JSON line ``{"metric", "value", "unit", "vs_baseline"}``;
``vs_baseline`` is null: no reference figure measured on this card exists.
Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

N_FRAMES = 100
WIDTH, HEIGHT = 512, 384
MAX_KPS = 512
MIN_REGISTERED, MAX_ATE = N_FRAMES - 5, 0.1
BENCH_OPTIONS = dict(
    min_initial_inliers=100, min_matches=25, match_ratio=0.85,
    init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=16384, refine_max_iters=30, global_max_iters=50,
    match_chunk=32, local_ba_every=4)


def render_workload(rng):
    """100-frame orbit through a blob field, with GT poses (untimed)."""
    from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses, render_view

    f = 1.2 * max(WIDTH, HEIGHT)
    intr = np.array([f, f, WIDTH / 2, HEIGHT / 2], np.float32)
    scene = make_blob_scene(rng, n_blobs=900, depth=(3.5, 9.0), spread=2.6)
    poses = orbit_poses(N_FRAMES, radius=0.6, step_deg=0.5, advance=0.03)
    images = np.stack([render_view(scene, T, intr, WIDTH, HEIGHT) for T in poses])
    return images, poses, intr


def scene_ate(scene, poses_gt) -> float:
    """ATE RMSE of the scene's registered cameras against ground truth."""
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    valid = scene.pose_valid.cpu().numpy()
    return trajectory_ate(scene.pose.cpu().numpy()[valid], poses_gt[valid])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the RANSAC draws")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_gpu: no CUDA device", file=sys.stderr)
        return 1
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# {card}", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    images_np, poses_gt, intr = render_workload(np.random.default_rng(0))
    print(f"# rendered {N_FRAMES} frames {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    images = torch.as_tensor(images_np, device=dev)
    opts = SfmOptions(seed=args.seed, **BENCH_OPTIONS)

    def full_pipeline():
        """images -> features -> match -> reconstruct, one path.
        Returns (scene, stats, t_extract, total)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xy, desc, _, mask = extract_features(images, max_keypoints=MAX_KPS, device=dev)
        torch.cuda.synchronize()
        t_extract = time.perf_counter() - t0
        scene, stats = run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                               options=opts, verbose=False, device=dev)
        torch.cuda.synchronize()
        return scene, stats, t_extract, time.perf_counter() - t0

    _, _, _, warm_s = full_pipeline()
    print(f"# warm-up pass (kernel build, allocator and cuDNN caches): {warm_s:.2f}s",
          flush=True)
    scene, stats, t_extract, total = full_pipeline()

    # ---- correctness gate ---------------------------------------------------
    rmse = scene_ate(scene, poses_gt)
    secs = ", ".join(f"{k} {v:.3f}" for k, v in stats["seconds"].items())
    print(f"# registered {stats['registered']}/{N_FRAMES}, landmarks {stats['landmarks']}, "
          f"ATE {rmse:.4f}, extract {t_extract:.3f}s / total {total:.3f}s ({secs})", flush=True)
    if stats["registered"] < MIN_REGISTERED:
        raise RuntimeError(f"bench gate: {stats['registered']} of {N_FRAMES} frames registered")
    if not rmse < MAX_ATE:
        raise RuntimeError(f"bench gate: ATE {rmse}")
    print(json.dumps({"metric": "sfm_frames_per_s", "value": round(N_FRAMES / total, 3),
                      "unit": "frames/s", "vs_baseline": None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
