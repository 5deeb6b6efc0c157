#!/usr/bin/env python3
"""Deep-frontend benchmark of the PyTorch/CUDA port: frames/s and ATE at
N=100 with windowed and retrieval pairs, on one NVIDIA card.

    python scripts/bench_deep_torch.py [--frames 100 --window 10 --scenes 5]

``scripts/bench_deep.py``'s workload and recipe on ``eacham_tpu_torch``:
the shipped SuperPoint -> ``extract_deep_batch(K=1024)`` with subpixel
refinement -> LightGlue over the windowed and retrieval candidate pairs
(window 10, retrieval 3, threshold 0.15, epipolar verification with seed 7)
-> ``run_sfm(match_tables=...)`` with the deep options (60 initial inliers,
local BA every 3rd registration). The images are uploaded outside the
timed region; a warm-up pass on world 0 comes first (kernel build,
allocator and cuDNN caches), then one timed pass ending in
``torch.cuda.synchronize()``. Worlds 1..scenes-1 (blob fields from those
seeds) and the textured-surface worlds follow, untimed. The recipe (the
worlds, the options, the front half) is ``chip_smoke.py``'s, whose
``deep_sfm`` phase runs the same five blob worlds; the worlds are rendered
by its process pool before the first pass.

Gate, as the reference's: every blob world at least frames - 5 registered
and the median ATE over the blob worlds under 0.1. The surface rows are
reported and not gated. Prints the card's name and power limit, ``#``
lines per pass and world, and last ONE JSON line with
``scripts/bench_deep.py``'s keys plus ``card`` and ``registered_scenes``.
Without a CUDA device it exits non-zero.
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


def main() -> int:
    import torch

    from chip_smoke import (
        DEEP_KPS, DEEP_OPTIONS, DEEP_THRESHOLD, DEEP_WINDOW, HEIGHT, N_FRAMES, WIDTH,
        card_line, deep_front, deep_world, render_views)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--window", type=int, default=DEEP_WINDOW)
    ap.add_argument("--kps", type=int, default=DEEP_KPS)
    ap.add_argument("--threshold", type=float, default=DEEP_THRESHOLD)
    ap.add_argument("--scenes", type=int, default=5, help="blob worlds for the median-ATE gate")
    ap.add_argument("--surface-scenes", type=int, default=3,
                    help="textured-surface worlds for the second-domain rows (0 = blob only)")
    ap.add_argument("--weights", default=None,
                    help="alternate weights dir (default: the repo's weights/)")
    ap.add_argument("--no-gate", action="store_true",
                    help="report without applying the gate")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_deep_torch: no CUDA device", file=sys.stderr)
        return 1
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import trajectory_ate
    from eacham_tpu_torch.utils.synthetic import make_surface_scene, orbit_poses

    card = card_line()
    print(f"# {card}", flush=True)
    dev = torch.device("cuda", 0)
    N = args.frames
    worlds = [deep_world(s, N) for s in range(args.scenes)]
    _, poses, intr = worlds[0]
    # the textured-surface worlds at the robustness matrix's orbit geometry
    poses_s = orbit_poses(N, radius=0.6, step_deg=0.8, advance=0.04)
    worlds += [(make_surface_scene(np.random.default_rng(w), n_blobs=4000), poses_s, intr)
               for w in range(args.surface_scenes)]
    t0 = time.perf_counter()
    rendered, workers = render_views(worlds)
    print(f"# rendered {len(worlds)} worlds of {N} frames in {time.perf_counter() - t0:.1f}s "
          f"with {workers} processes", flush=True)
    blob_images, surface_images = rendered[:args.scenes], rendered[args.scenes:]
    models = load_frontend_params(weights_dir=args.weights, device=dev)[:2]
    print(f"# matcher: {models[1].n_layers}-layer (threshold {args.threshold})", flush=True)
    opts = SfmOptions(**DEEP_OPTIONS)

    def full(imgs_dev):
        torch.cuda.synchronize()
        xy, desc, mask, tables, t_ex, t_match = deep_front(
            models, imgs_dev, intr, dev, kps=args.kps, window=args.window,
            threshold=args.threshold)
        scene, stats = run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                               options=opts, verbose=False, match_tables=tables, device=dev)
        torch.cuda.synchronize()
        return scene, stats, t_ex, t_match

    def ate_of(scene, gt):
        valid = scene.pose_valid.cpu().numpy()
        return trajectory_ate(scene.pose.cpu().numpy()[valid], gt[valid])

    # the upload happens outside the timed region, as in the reference
    imgs_dev = torch.as_tensor(blob_images[0], device=dev)
    t0 = time.perf_counter()
    full(imgs_dev)
    print(f"# warmup: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    scene, stats, t_ex, t_match = full(imgs_dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    rmse = ate_of(scene, poses)
    secs = ", ".join(f"{k} {v:.3f}" for k, v in stats["seconds"].items())
    print(f"# registered {stats['registered']}/{N}, landmarks {stats['landmarks']}, ATE "
          f"{rmse:.4f} (extract {t_ex:.3f}s, match {t_match:.3f}s, total {total:.3f}s; {secs}) "
          f"on {card}", flush=True)

    # the accuracy claim is the median over independently rendered worlds;
    # frames/s is world 0's
    ates, regs = [rmse], [int(stats["registered"])]
    for s in range(1, args.scenes):
        sc, st, _, _ = full(torch.as_tensor(blob_images[s], device=dev))
        ates.append(ate_of(sc, poses))
        regs.append(int(st["registered"]))
        print(f"# scene {s}: registered {st['registered']}/{N}, ATE {ates[-1]:.4f}", flush=True)
    med_ate = float(np.median(ates))

    surf_ates, surf_regs = [], []
    for w, imgs_w in enumerate(surface_images):
        sc, st, _, _ = full(torch.as_tensor(imgs_w, device=dev))
        surf_ates.append(ate_of(sc, poses_s))
        surf_regs.append(int(st["registered"]))
        print(f"# surface world {w}: registered {st['registered']}/{N}, "
              f"ATE {surf_ates[-1]:.4f}", flush=True)
    med_surf = float(np.median(surf_ates)) if surf_ates else None

    if not args.no_gate:
        if min(regs) < N - 5:
            raise RuntimeError(f"deep bench gate: registered {regs}")
        if not med_ate < 0.1:
            raise RuntimeError(f"deep bench gate: median ATE {med_ate}")
    print(json.dumps({
        "metric": "deep_sfm_frames_per_s",
        "value": round(N / total, 3),
        "unit": "frames/s",
        "ate": round(med_ate, 4) if np.isfinite(med_ate) else None,
        "ate_scenes": [round(float(a), 4) for a in ates],
        "registered": int(stats["registered"]),
        "registered_scenes": regs,
        "surface_registered": surf_regs,
        "surface_ate": (round(med_surf, 4)
                        if med_surf is not None and np.isfinite(med_surf) else None),
        "surface_ates": [round(float(a), 4) for a in surf_ates],
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
