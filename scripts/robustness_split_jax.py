#!/usr/bin/env python3
"""Nuisance cells of ``scripts/robustness_matrix.py`` over RANSAC seeds on
the JAX package, on the CPU, with the frontend's features exchangeable
between the two packages: the reference side of
``scripts/robustness_split_torch.py``.

    JAX_PLATFORMS=cpu python scripts/robustness_split_jax.py [--cells blur:sigma=1.0px]
        [--seeds 16] [--save-features DIR] [--features DIR]

The reference script's recipe, its own ``apply_nuisance`` (the script
loaded by path; its file is never written): three surface worlds of 60
frames at 512x384, ``extract_features(K=512)`` -> ``run_sfm`` with the
script's options (``chip_smoke.py``'s ROBUST_OPTIONS, the same values) and
``SfmOptions.seed`` 0..N-1. ``--save-features`` / ``--features`` write and
read the port script's files, so either package's ``run_sfm`` runs on
either package's features. Prints the port script's lines and a JSON line
last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def reference_script():
    spec = importlib.util.spec_from_file_location(
        "robustness_matrix", ROOT / "scripts" / "robustness_matrix.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def render_worlds(n_frames=60, n_worlds=3, size=(512, 384)):
    """The reference script's worlds: (images a world, poses, intr)."""
    from eacham_tpu.utils.synthetic import make_surface_scene, orbit_poses, render_view

    f = 1.2 * max(size)
    intr = np.array([f, f, size[0] / 2, size[1] / 2], np.float32)
    poses = orbit_poses(n_frames, radius=0.6, step_deg=0.8, advance=0.04)
    worlds = [np.stack([render_view(make_surface_scene(np.random.default_rng(w), n_blobs=4000),
                                    T, intr, *size) for T in poses])
              for w in range(n_worlds)]
    return worlds, poses, intr


def split(worlds, poses, intr, cells, seeds, features=None, save=None) -> list[dict]:
    """One row a cell and seed, as ``robustness_split_torch.split``."""
    import jax.numpy as jnp

    from chip_smoke import MAX_KPS, ROBUST_OPTIONS
    from eacham_tpu.features.frontend import extract_features
    from eacham_tpu.sfm import SfmOptions, run_sfm
    from eacham_tpu.utils.evaluate import ate_rmse
    from scripts.robustness_split_torch import feature_file

    ref = reference_script()
    rows = []
    for family, level in cells:
        inputs = []
        for w, images in enumerate(worlds):
            imgs, keep = ref.apply_nuisance(images, np.random.default_rng(7 + w),
                                            **dict(ref.NUISANCES[family])[level])
            gt = poses[keep] if keep is not None else poses
            if features:
                d = np.load(feature_file(features, family, level, w))
                xy, desc, mask = d["xy"], d["desc"], d["mask"]
            else:
                xy, desc, _, mask = (np.asarray(a) for a in extract_features(
                    jnp.asarray(imgs), max_keypoints=MAX_KPS))
            if save:
                Path(save).mkdir(parents=True, exist_ok=True)
                np.savez(feature_file(save, family, level, w), xy=xy, desc=desc, mask=mask)
            inputs.append((imgs.shape, gt, xy, desc, mask))
        for seed in range(seeds):
            t0 = time.perf_counter()
            regs, ates = [], []
            for (n, h, w), gt, xy, desc, mask in inputs:
                scene, _ = run_sfm(jnp.asarray(xy), jnp.asarray(desc), jnp.asarray(mask),
                                   image_size=(w, h), intr=jnp.asarray(intr),
                                   options=SfmOptions(**ROBUST_OPTIONS, seed=seed),
                                   verbose=False)
                valid = np.asarray(scene.pose_valid)
                if valid.sum() < 3:
                    regs.append(0.0)
                    ates.append(float("inf"))
                    continue
                est = np.asarray(scene.pose)[valid]
                c_est = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
                c_gt = -np.einsum("nij,ni->nj", gt[valid][:, :3, :3], gt[valid][:, :3, 3])
                regs.append(float(valid.sum() / n))
                ates.append(float(ate_rmse(c_est, c_gt)))
            row = {"family": family, "level": level, "seed": seed, "registered": min(regs),
                   "ate": float(np.median(ates)), "ates": ates,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(f"[{family:12s} {level:14s}] seed {seed:2d} reg>={row['registered']:5.1%} "
                  f"ATE~{row['ate']:8.4f} ({'/'.join(f'{a:.3f}' for a in ates)}) "
                  f"({row['seconds']:.1f}s)", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="blur:sigma=1.0px",
                    help="comma-separated family:level (the clean cell: 'clean:')")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--features", metavar="DIR",
                    help="run on these features (the port's, say) instead of the JAX package's")
    ap.add_argument("--save-features", metavar="DIR")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from scripts.robustness_split_torch import parse_cells, summary

    cells = parse_cells(args.cells)
    print(f"# eacham_tpu on the CPU; features: {args.features or 'the JAX package'}",
          flush=True)
    worlds, poses, intr = render_worlds()
    rows = split(worlds, poses, intr, cells, args.seeds, args.features, args.save_features)
    sums = [summary(rows, *c) for c in cells]
    for s in sums:
        print(f"[{s['family']:12s} {s['level']:14s}] over seeds 0-{s['seeds'] - 1}: median "
              f"{s['median']:.4f}, range {s['min']:.4f}-{s['max']:.4f}, {s['over']} over "
              f"{s['limit']:.4f}", flush=True)
    print(json.dumps({"package": "eacham_tpu", "platform": "cpu",
                      "features": args.features or "own", "summary": sums, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
