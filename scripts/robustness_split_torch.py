#!/usr/bin/env python3
"""Nuisance cells of ``scripts/robustness_matrix.py`` over RANSAC seeds on
the PyTorch/CUDA port, with the frontend's features exchangeable between
the two packages: which half of the classical path moves a cell's ATE.

    python scripts/robustness_split_torch.py [--cells blur:sigma=1.0px,clean:] [--seeds 16]
        [--save-features DIR] [--features DIR] [--device cpu]

The matrix's recipe (``chip_smoke.py``'s one copy): three surface worlds of
60 frames at 512x384, each cell's nuisance drawn from ``default_rng(7 +
world)``, ``extract_features(K=512)`` -> ``run_sfm`` with ROBUST_OPTIONS
and ``SfmOptions.seed`` 0..N-1. ``--save-features DIR`` writes each world's
keypoints, descriptors and mask (``<cell>_w<world>.npz``); ``--features
DIR`` runs ``run_sfm`` on such files instead of the port's own features,
e.g. those of ``scripts/robustness_split_jax.py --save-features``, which
does the same with the JAX package. So the four runs (either package's
``run_sfm`` on either package's features, each through the normal path
with its match-graph verification) say whether a cell's spread comes with
the features or with the back half.

Prints one line a cell and seed (least registered share over the worlds,
median ATE, each world's ATE), one summary line a cell (median, range and
count over the cell's limit of the seeds' medians) and one JSON line with
every row and the card's name and power limit last. Without a CUDA device
and without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    MAX_KPS, NUISANCES, ROBUST_MAX_ATE, ROBUST_MAX_ATE_OF, ROBUST_OPTIONS, apply_nuisance,
    robust_worlds)


def feature_file(folder, family, level, world) -> Path:
    """The file of one cell's world: ``blur_sigma_1.0px_w0.npz``."""
    stem = re.sub(r"[^0-9A-Za-z.]+", "_", f"{family}_{level}").strip("_")
    return Path(folder) / f"{stem}_w{world}.npz"


def parse_cells(text: str) -> list[tuple[str, str]]:
    cells = [tuple(c.split(":", 1)) for c in text.split(",") if c]
    for family, level in cells:
        if level not in dict(NUISANCES.get(family, ())):
            raise SystemExit(f"unknown cell {family}:{level}")
    return cells


def summary(rows, family, level) -> dict:
    """The seeds' cell medians of one cell: median, range, count over the
    cell's limit (``chip_smoke.py``'s gate)."""
    ates = [r["ate"] for r in rows if (r["family"], r["level"]) == (family, level)]
    limit = ROBUST_MAX_ATE_OF.get((family, level), ROBUST_MAX_ATE)
    return {"family": family, "level": level, "seeds": len(ates),
            "median": float(np.median(ates)), "min": min(ates), "max": max(ates),
            "limit": limit, "over": sum(not a < limit for a in ates)}


def split(worlds, poses, intr, cells, seeds, dev, features=None, save=None) -> list[dict]:
    """One row a cell and seed: ``run_sfm`` on the port's features of each
    world (or those in ``features``), saving them to ``save``."""
    import torch
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    rows = []
    for family, level in cells:
        inputs = []
        for w, images in enumerate(worlds):
            imgs, keep = apply_nuisance(images, np.random.default_rng(7 + w),
                                        **dict(NUISANCES[family])[level])
            gt = poses[keep] if keep is not None else poses
            if features:
                d = np.load(feature_file(features, family, level, w))
                xy, desc, mask = d["xy"], d["desc"], d["mask"]
            else:
                xy, desc, _, mask = (t.cpu().numpy() for t in extract_features(
                    torch.as_tensor(imgs, device=dev), max_keypoints=MAX_KPS, device=dev))
            if save:
                Path(save).mkdir(parents=True, exist_ok=True)
                np.savez(feature_file(save, family, level, w), xy=xy, desc=desc, mask=mask)
            inputs.append((imgs.shape, gt, xy, desc, mask))
        for seed in range(seeds):
            t0 = time.perf_counter()
            regs, ates = [], []
            for (n, h, w), gt, xy, desc, mask in inputs:
                scene, _ = run_sfm(xy, desc, mask, image_size=(w, h), intr=intr,
                                   options=SfmOptions(**ROBUST_OPTIONS, seed=seed), device=dev)
                valid = scene.pose_valid.cpu().numpy()
                enough = valid.sum() >= 3
                regs.append(float(valid.sum() / n) if enough else 0.0)
                ates.append(trajectory_ate(scene.pose.cpu().numpy()[valid], gt[valid])
                            if enough else float("inf"))
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
                    help="run on these features (the JAX package's, say) instead of the port's")
    ap.add_argument("--save-features", metavar="DIR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    cells = parse_cells(args.cells)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("robustness_split_torch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (no card)"
    print(f"# {card}; features: {args.features or 'the port'}", flush=True)
    worlds, poses, intr, _ = robust_worlds()
    rows = split(worlds, poses, intr, cells, args.seeds, dev, args.features, args.save_features)
    sums = [summary(rows, *c) for c in cells]
    for s in sums:
        print(f"[{s['family']:12s} {s['level']:14s}] over seeds 0-{s['seeds'] - 1}: median "
              f"{s['median']:.4f}, range {s['min']:.4f}-{s['max']:.4f}, {s['over']} over "
              f"{s['limit']:.4f}", flush=True)
    print(json.dumps({"package": "eacham_tpu_torch", "features": args.features or "own",
                      "summary": sums, "rows": rows, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
