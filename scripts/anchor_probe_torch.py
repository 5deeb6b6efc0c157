#!/usr/bin/env python3
"""The 1000-frame observability probe on the PyTorch/CUDA port: ATE without
and with five absolute pose anchors (``scripts/anchor_probe.py`` on
``eacham_tpu_torch``).

    python scripts/anchor_probe_torch.py --frames 1000            # on the card
    python scripts/anchor_probe_torch.py --frames 60 --device cpu  # smoke, no card

The recipe is ``chip_smoke.py``'s, whose ``anchors`` phase runs it with its
gate: scripts/stress_500.py's surface world and orbit at ``--frames``
frames, rendered by its process pool, ``extract_features`` in chunks of
500, ``run_sfm`` with ``ANCHOR_OPTIONS`` (the arguments below override the
landmark capacity, the global BA's iterations and rounds and the anchors'
position sigma), then ``--anchors`` frames spread evenly over the
registered ones anchored to their ground truth expressed in the
reconstruction's frame (``sfm.anchors_in_estimate_frame``) and
``resume_sfm(abs_anchors=...)``. Prints the reference script's lines, its
verdict, and one JSON line with both ATEs, the stage seconds and the card's
name and power limit. ``--cache`` keeps the features in the reference
script's file format. Without a CUDA device and without ``--device cpu``
it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def features(args, dev):
    """The rendered frames' features (xy, desc, mask) on ``dev``, from
    ``--cache`` when it holds this size, and the ground-truth poses and
    intrinsics."""
    import torch

    from chip_smoke import LOOP_EXTRACT_CHUNK, render_loop_workload, sync
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.utils.synthetic import stress_orbit_poses

    N, W, H = args.frames, args.width, args.height
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    cache = Path(args.cache) if args.cache else None
    if cache is not None and cache.exists():
        d = np.load(cache)
        if (int(d["n"]), int(d["w"]), int(d["h"]), int(d["kps"])) == (N, W, H, args.kps):
            print(f"features from cache {cache}", flush=True)
            return ([torch.as_tensor(d[k], device=dev) for k in ("xy", "desc", "mask")],
                    stress_orbit_poses(N), intr)
    t0 = time.perf_counter()
    images, poses, intr, _ = render_loop_workload(N, size=(W, H))
    print(f"rendered {N} frames in {time.perf_counter() - t0:.0f}s", flush=True)
    t0 = time.perf_counter()
    parts = []
    for lo in range(0, N, LOOP_EXTRACT_CHUNK):
        imgs = torch.as_tensor(images[lo:lo + LOOP_EXTRACT_CHUNK], device=dev)
        parts.append(extract_features(imgs, max_keypoints=args.kps, device=dev))
    xy, desc, mask = (torch.cat([p[i] for p in parts]) for i in (0, 1, 3))
    sync(dev)
    print(f"extract: {time.perf_counter() - t0:.1f}s", flush=True)
    if cache is not None:
        np.savez(cache, xy=xy.cpu().numpy(), desc=desc.cpu().numpy(),
                 mask=mask.cpu().numpy(), n=N, w=W, h=H, kps=args.kps)
    return [xy, desc, mask], poses, intr


def main() -> int:
    from chip_smoke import ANCHOR_COUNT, ANCHOR_FRAMES, ANCHOR_OPTIONS, HEIGHT, LOOP_KPS, WIDTH

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=ANCHOR_FRAMES)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--kps", type=int, default=LOOP_KPS)
    ap.add_argument("--anchors", type=int, default=ANCHOR_COUNT)
    ap.add_argument("--global-iters", type=int, default=ANCHOR_OPTIONS["global_max_iters"])
    ap.add_argument("--lm-capacity", type=int, default=ANCHOR_OPTIONS["lm_capacity"])
    ap.add_argument("--ba-program-iters", type=int, default=ANCHOR_OPTIONS["ba_program_iters"])
    ap.add_argument("--cache", default=None,
                    help="feature cache (.npz, the reference script's format); none by default")
    ap.add_argument("--sigma", type=float, default=ANCHOR_OPTIONS["abs_sigma_pos"],
                    help="anchor position sigma in scene units (orbit radius is 14)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("anchor_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _ate, anchor_distances, anchor_ids_of, card_line, scene_digest, sync
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm import SfmOptions, anchors_in_estimate_frame, resume_sfm, run_sfm

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (no card)"
    print(f"# {card}", flush=True)
    N = args.frames
    (xy, desc, mask), poses, intr = features(args, dev)
    opts = SfmOptions(**dict(
        ANCHOR_OPTIONS, lm_capacity=args.lm_capacity, global_max_iters=args.global_iters,
        ba_program_iters=args.ba_program_iters, abs_sigma_pos=args.sigma))

    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    scene, stats = run_sfm(xy, desc, mask, image_size=(args.width, args.height), intr=intr,
                           options=opts, verbose=True, device=dev)
    sync(dev)
    t_base = time.perf_counter() - t0
    launches = [launch_counts()["match_pairs"]]
    print(f"baseline reconstruct: {t_base:.0f}s", flush=True)
    valid = scene.pose_valid.cpu().numpy()
    ate0 = _ate(scene.pose, scene.pose_valid, poses)
    print(f"ATE without anchors: {ate0:.4f} ({stats['registered']}/{N} registered)", flush=True)

    ids = anchor_ids_of(valid, args.anchors)
    print(f"anchoring frames {ids.tolist()} (sigma pos {args.sigma}, rot "
          f"{opts.abs_sigma_rot} rad)", flush=True)
    anchors, anchor_mask = anchors_in_estimate_frame(scene.pose, poses, ids, valid=valid)
    reset_launch_counts()
    t0 = time.perf_counter()
    scene2, stats2 = resume_sfm(scene, options=opts, verbose=True,
                                abs_anchors=(anchors, anchor_mask), device=dev)
    sync(dev)
    t_anchored = time.perf_counter() - t0
    launches.append(launch_counts()["match_pairs"])
    ate1 = _ate(scene2.pose, scene2.pose_valid, poses)
    print(f"anchored finalize: {t_anchored:.0f}s", flush=True)
    print(f"ATE with {args.anchors} absolute anchors: {ate1:.4f} (was {ate0:.4f})", flush=True)
    print("CONFIRMED: the residual error was the unobservable warp (removed by absolute "
          "references)" if ate1 < 0.35 * ate0 else
          "NOT confirmed: anchors did not collapse ATE -> solver deficiency to chase", flush=True)
    print(json.dumps({
        "frames": N, "anchors": ids.tolist(), "options": dataclasses.asdict(opts),
        "registered": [stats["registered"], stats2["registered"]],
        "landmarks": [stats["landmarks"], stats2["landmarks"]],
        "ate": [ate0, ate1], "ratio": ate0 / ate1,
        "anchor_error": anchor_distances(scene2.pose, anchors, ids),
        "seconds": {"baseline": t_base, "anchored": t_anchored,
                    "baseline_stages": stats["seconds"], "anchored_stages": stats2["seconds"]},
        "match_pairs_launches": launches, "digest": scene_digest(scene2), "card": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
