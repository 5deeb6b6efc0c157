"""Command-line SfM driver: ``python -m eacham_tpu_torch.cli <config.json>``
(port of eacham_tpu/cli.py).

The equivalent of the reference's ``sfm`` executable (apps/sfm/main.cpp:
31-269) minus the Pangolin window (results are exported, not rendered):
parse config -> load images -> extract features -> run the incremental
pipeline -> write transform.json, cloud.ply and trajectory.ply (+
transforms_nerf.json when ``nerfy`` is set, replacing the separate
TransformToNerf binary invocation).

The run is on the card unless ``--device cpu`` (``run(device="cpu")``) is
given; without a card it raises. The images are decoded on the host and
uploaded once. ``--devices N`` shards the match graph and the global BAs
over N processes launched together (``torchrun --nproc-per-node N -m
eacham_tpu_torch.cli cfg.json --devices N``); rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def run(config_path: str, max_keypoints: int = 1024, verbose: bool = True,
        frontend: str = "classical", weights_dir: str | None = None,
        n_devices: int = 1, match_threshold: float = 0.5,
        distortion=None, device: str | torch.device | None = "cuda") -> dict:
    """The whole CLI run. Returns ``run_sfm``'s stats with ``output`` (the
    transform.json path), ``decoder`` (``ImageBatch.backend``) and the
    frames ``loaded``."""
    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.io.config import load_config
    from eacham_tpu_torch.io.export import export_cloud, export_trajectory, landmark_colors
    from eacham_tpu_torch.io.images import load_image_dir
    from eacham_tpu_torch.io.nerf import transform_to_nerf
    from eacham_tpu_torch.io.saver import save_positions
    from eacham_tpu_torch.sfm.pipeline import run_sfm
    from eacham_tpu_torch.utils.timer import BlockTimer, print_stats

    dev = resolve_device(device)
    writer = True
    if n_devices > 1:
        from eacham_tpu_torch.parallel.mesh import init_distributed, make_mesh

        init_distributed(device=dev)
        writer = make_mesh(n_devices, device=dev).rank == 0    # raises without the group
    cfg = load_config(config_path)
    t_start = time.perf_counter()

    with BlockTimer("Load", verbose=verbose):
        batch = load_image_dir(cfg.images_path, max_count=cfg.max_data_size)
    if verbose:
        print(f"loaded {len(batch.names)} frames ({batch.backend} decoder)")

    # K guess from the FIRST frame's true size, as the reference does
    # (utils::ImageToCameraParams(frames[0].image), Utils.h:13-22)
    w0, h0 = (int(v) for v in batch.sizes[0])
    opts = cfg.to_options(max_keypoints=max_keypoints, n_devices=n_devices)

    deep_models = None
    if frontend == "deep":
        from eacham_tpu_torch.features.deep.frontend import (
            extract_deep_batch, load_frontend_params,
        )

        deep_models = load_frontend_params(weights_dir, device=dev)
        with BlockTimer("Extract(deep)", verbose=verbose):
            xy, desc, score, mask = extract_deep_batch(
                deep_models[0], batch.images, max_keypoints=max_keypoints, device=dev)
            mask.any().item()      # the stage ends when its results exist
    else:
        with BlockTimer("Extract", verbose=verbose):  # HOT LOOP 1 (main.cpp:72-79)
            xy, desc, score, mask = extract_features(
                batch.images, max_keypoints=max_keypoints, device=dev)
            mask.any().item()
    # unequal-size frames are zero-padded to the batch max; drop keypoints
    # that fired on padding (incl. the artificial image/pad edge)
    mask = mask & _in_frame_mask(xy, batch.sizes)
    if distortion is not None and any(float(d) != 0.0 for d in distortion):
        # undistort-on-ingest (ICamera.h:30-44 carries distortion that the
        # reference never applies): downstream stays pinhole-exact. This
        # happens BEFORE deep match tables are built so the epipolar
        # verification and SfM see the same (pinhole) coordinates, and the
        # in-frame mask is re-applied because undistortion can push edge
        # keypoints outside the frame.
        from eacham_tpu_torch.geometry.camera import (
            intrinsics_from_image_size, undistort_keypoints,
        )

        xy = undistort_keypoints(
            xy, intrinsics_from_image_size(w0, h0, device=dev),
            torch.tensor([float(d) for d in distortion], dtype=torch.float32, device=dev))
        mask = mask & _in_frame_mask(xy, batch.sizes)
        if verbose:
            print(f"undistorted keypoints with [k1 k2 p1 p2 k3] = "
                  f"{list(distortion)}")
    match_tables = None
    if frontend == "deep":
        match_tables = _deep_match_tables(
            deep_models, (xy, desc, score, mask), verbose, opts, (w0, h0),
            match_threshold)
    with BlockTimer("SfM", verbose=verbose):       # match + loop + BA
        scene, stats = run_sfm(
            xy, desc, mask,
            image_size=(w0, h0),
            options=opts, verbose=verbose,
            match_tables=match_tables, device=dev,
        )

    # ---- export (main.cpp:237-264) -------------------------------------------
    out_path = Path(cfg.output_transform_path)
    if not writer:
        stats.update(output=str(out_path), decoder=batch.backend, loaded=len(batch.names))
        return stats
    with BlockTimer("Export", verbose=verbose):
        valid = scene.pose_valid.cpu().numpy()
        poses = scene.pose.cpu().numpy()
        names = [batch.names[i] for i in range(len(batch.names)) if valid[i]]
        intr = scene.intr.cpu().numpy()
        out_path.parent.mkdir(parents=True, exist_ok=True)
        save_positions(
            out_path, names, poses[valid],
            width=w0, height=h0,
            cx=float(intr[2]), cy=float(intr[3]),
            fx=float(intr[0]), fy=float(intr[1]),
        )
        # offline visualization artifacts (replace the Pangolin views)
        colors = landmark_colors(scene, batch.images)
        n_pts = export_cloud(out_path.parent / "cloud.ply", scene, color=colors)
        export_trajectory(out_path.parent / "trajectory.ply", scene)

    n_invalid = int((~valid).sum())
    if verbose:
        print(f"invalidNodes: {n_invalid} out of {len(batch.names)}")
        print(f"saved {out_path} (+cloud.ply [{n_pts} pts], trajectory.ply)")
    if cfg.nerfy:
        nerf_out = transform_to_nerf(out_path.parent)
        if verbose:
            print(f"saved {nerf_out}")
    if verbose:
        print(f"[SfM] total time: {(time.perf_counter() - t_start) * 1e3:.0f} ms")
        print_stats()
    stats.update(output=str(out_path), decoder=batch.backend, loaded=len(batch.names))
    return stats


def _in_frame_mask(xy: torch.Tensor, sizes) -> torch.Tensor:
    """[N, K] mask of keypoints inside each frame's true (w, h) extent
    (ImageBatch.sizes) — padding regions never produce features."""
    wh = torch.as_tensor(np.asarray(sizes), dtype=xy.dtype, device=xy.device)[:, None, :]
    return ((xy >= 0) & (xy < wh)).all(-1)


def _deep_match_tables(deep_models, feats, verbose, opts, image_size,
                       match_threshold=0.5):
    """LightGlue matching over the SAME candidate-pair graph policy as the
    classical path (window + ladder + retrieval + epipolar verification),
    on already-extracted (and already-undistorted, when a lens model is
    given) features. The verification's generator is seeded 7."""
    from eacham_tpu_torch.features.deep.frontend import build_match_tables_deep
    from eacham_tpu_torch.geometry.camera import intrinsics_from_image_size
    from eacham_tpu_torch.utils.timer import BlockTimer

    _, matcher, _ = deep_models
    xy, desc, score, mask = feats
    dev = xy.device
    with BlockTimer("Match(deep)", verbose=verbose):
        verify = None
        if opts.verify_hyps > 0:
            verify = (intrinsics_from_image_size(*image_size, device=dev),
                      torch.Generator(device=dev).manual_seed(7), opts.max_repr_error,
                      opts.verify_hyps)
        tables = build_match_tables_deep(
            matcher, xy, desc, mask, image_size,
            min_matches=opts.min_matches,
            pair_window=opts.pair_window,
            retrieval_k=opts.pair_retrieval_k, ladder=opts.pair_ladder,
            verify=verify, threshold=match_threshold, device=dev,
        )
        tables[1].any().item()
    return tables


def main(argv=None):
    ap = argparse.ArgumentParser(description="eacham_tpu_torch SfM pipeline")
    ap.add_argument("config", help="path to SfmConfig-style JSON")
    ap.add_argument("--max-keypoints", type=int, default=1024)
    ap.add_argument("--frontend", choices=["classical", "deep"],
                    default="classical")
    ap.add_argument("--weights", help="directory with deep-frontend .npz")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard matching + global BA over this many devices: one "
                         "process each, launched by torchrun --nproc-per-node N")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the pipeline runs (default: the card; without "
                         "one the run fails unless cpu is asked for)")
    ap.add_argument("--match-threshold", type=float, default=0.5,
                    help="deep-matcher score gate (reference default 0.5; "
                         "the measured high-recall point is 0.3 -- the "
                         "epipolar verification cleans the extra matches)")
    ap.add_argument("--distortion", default=None,
                    help="lens model 'k1,k2,p1,p2,k3' (Brown-Conrady); "
                         "keypoints are undistorted on ingest")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    dist = (None if args.distortion is None
            else [float(v) for v in args.distortion.split(",")])
    if dist is not None and len(dist) != 5:
        ap.error("--distortion needs 5 comma-separated values")
    stats = run(args.config, max_keypoints=args.max_keypoints,
                verbose=not args.quiet, frontend=args.frontend,
                weights_dir=args.weights, n_devices=args.devices,
                match_threshold=args.match_threshold, distortion=dist,
                device=args.device)
    return 0 if stats.get("initialized") else 1


if __name__ == "__main__":
    sys.exit(main())
