#!/usr/bin/env python3
"""Photometric and temporal nuisance matrix on the PyTorch/CUDA port
(``scripts/robustness_matrix.py`` on ``eacham_tpu_torch``), on one NVIDIA
card.

    python scripts/robustness_matrix_torch.py [--frames 60] [--worlds 3] [--md]
        [--frontend classical|deep] [--threshold 0.15] [--weights DIR] [--device cpu]

The reference's recipe: ``--worlds`` textured-surface worlds
(``make_surface_scene(default_rng(w), n_blobs=4000)``), ``--frames`` frames
of its orbit at 512x384, each nuisance of ``NUISANCES`` (sensor noise,
blur, exposure and vignetting, noise with blur, dropped frames) applied by
``apply_nuisance`` with ``default_rng(7 + w)``, and the full pipeline on
each world: the classical column ``extract_features(K=512)`` ->
``run_sfm`` (the match graph in one launch of the batched matcher's CUDA
kernel), or the deep column (``--frontend deep``) SuperPoint
``extract_deep_batch(K=1024)`` -> LightGlue over all pairs at
``--threshold`` (the attention in ``csrc/masked_attention.cu``),
epipolar-verified with seed 7 -> ``run_sfm(match_tables=...)``; the
bench's options with a local BA every 3rd registration. Each cell reports
the least registered share over the worlds and the median ATE. The
recipe is ``chip_smoke.py``'s, whose ``robustness`` phase runs four of the
cells with a gate; the worlds are rendered by its process pool.

Prints the reference's line per cell (and its markdown table with
``--md``), writes the cells to ``robustness_matrix_torch.json`` in the
working directory (the deep column to ``robustness_matrix_deep_torch.json``;
never the reference's file names, which hold its own figures), and prints
one JSON line with the cells, each run's record and the card's name and
power limit last. Without a CUDA device and without ``--device cpu`` it
exits non-zero.
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

# the recipe's one copy
from chip_smoke import (  # noqa: E402
    MAX_KPS, NUISANCES, ROBUST_DEEP_KPS, ROBUST_DEEP_THRESHOLD, ROBUST_FRAMES, ROBUST_WORLDS,
    apply_nuisance, robust_run, robust_worlds, vignette)

__all__ = ["NUISANCES", "apply_nuisance", "run_cell", "vignette"]


def run_cell(images_np, poses_gt, intr, dev, frontend="classical", models=None,
             threshold=ROBUST_DEEP_THRESHOLD):
    """The reference's ``run_cell`` on the port: (registered share, ATE,
    the run's record)."""
    _, _, rec, _ = robust_run(images_np, poses_gt, intr, dev, frontend, models, threshold)
    return rec["registered"], rec["ate"], rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=ROBUST_FRAMES)
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--worlds", type=int, default=ROBUST_WORLDS)
    ap.add_argument("--frontend", choices=["classical", "deep"], default="classical",
                    help="deep = the SuperPoint + LightGlue column")
    ap.add_argument("--threshold", type=float, default=ROBUST_DEEP_THRESHOLD)
    ap.add_argument("--weights", default=None,
                    help="deep weights directory (default: the repo's weights/)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("robustness_matrix_torch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (no card)"
    print(f"# {card}", flush=True)
    t0 = time.time()
    # single-world ATE on this pipeline rides on its draws: every cell is the
    # MEDIAN over --worlds independently rendered surface worlds
    worlds, poses, intr, workers = robust_worlds(args.frames, args.worlds)
    print(f"# rendered {args.worlds} x {args.frames} textured-surface frames in "
          f"{time.time() - t0:.0f}s ({workers} processes)", flush=True)

    models = None
    if args.frontend == "deep":
        from eacham_tpu_torch.features.deep.frontend import load_frontend_params

        superpoint, matcher, n_layers = load_frontend_params(weights_dir=args.weights,
                                                             device=dev)
        models = (superpoint, matcher)
        print(f"# deep frontend: {n_layers}-layer matcher, t={args.threshold}; budgets are "
              f"PER-FRONTEND production operating points (classical {MAX_KPS} kps, deep "
              f"{ROBUST_DEEP_KPS}) — columns compare production configs, not equal budgets",
              flush=True)

    rows, records = [], []
    for family, cells in NUISANCES.items():
        for label, kw in cells:
            regs, ates, n_frames = [], [], 0
            t0 = time.time()
            for w, images in enumerate(worlds):
                nrng = np.random.default_rng(7 + w)
                imgs, keep = apply_nuisance(images, nrng, **kw)
                gt = poses[keep] if keep is not None else poses
                reg, ate, rec = run_cell(imgs, gt, intr, dev, frontend=args.frontend,
                                         models=models, threshold=args.threshold)
                regs.append(reg)
                ates.append(ate)
                records.append({"family": family, "level": label, "world": w, **rec})
                n_frames = len(imgs)
            reg = float(np.min(regs))
            ate = float(np.median(ates))
            rows.append((family, label, n_frames, reg, ate, time.time() - t0))
            print(f"[{family:12s} {label:14s}] frames={n_frames:3d} "
                  f"reg>={reg:5.1%} ATE~{ate:8.4f} "
                  f"({'/'.join(f'{a:.3f}' for a in ates)}) "
                  f"({rows[-1][5]:.0f}s)", flush=True)

    if args.md:
        print("\n| Nuisance | Level | Frames | Registered | ATE |")
        print("|---|---|---|---|---|")
        for fam, label, n, reg, ate, _ in rows:
            print(f"| {fam} | {label or '—'} | {n} | {reg:.1%} | {ate:.4f} |")
    out = [{"family": fam, "level": label, "frames": n,
            "registered": round(reg, 4), "ate": round(ate, 4)}
           for fam, label, n, reg, ate, _ in rows]
    name = ("robustness_matrix_torch.json" if args.frontend == "classical"
            else "robustness_matrix_deep_torch.json")
    Path(name).write_text(json.dumps(out, indent=2))
    print(json.dumps({"frontend": args.frontend, "frames": args.frames, "worlds": args.worlds,
                      "cells": [dict(c, seconds=r[5]) for c, r in zip(out, rows)],
                      "runs": records, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
