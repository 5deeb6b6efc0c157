"""End-to-end demo on a rendered synthetic scene (no dataset needed), on the
PyTorch/CUDA port.

The port's counterpart of ``examples/reconstruct_synthetic.py``: renders a
12-frame blob-field sequence with known poses, reconstructs it with the
full pipeline (``extract_features`` -> ``run_sfm``: the match graph in
one launch of the batched matcher's CUDA kernel, two-view init, the
registration sweep, global BA), reports ATE against the generating
trajectory, and writes transform.json + PLY exports.

    python examples/reconstruct_synthetic_torch.py [out_dir] [--device cpu]

``out_dir`` defaults to ``eacham_demo`` in the temporary directory. Runs
on the card unless ``--device cpu`` is given; without a card and without
that flag it exits with an error.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default=str(Path(tempfile.gettempdir()) / "eacham_demo"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.io.export import export_cloud, export_trajectory
    from eacham_tpu_torch.io.saver import save_positions
    from eacham_tpu_torch.sfm import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import ate_rmse
    from eacham_tpu_torch.utils.synthetic import render_sequence

    dev = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(0)
    print("rendering 12-frame synthetic sequence ...")
    images, poses_gt, intr = render_sequence(
        rng, n_frames=12, width=320, height=240, n_blobs=350)

    xy, desc, score, mask = extract_features(images, max_keypoints=512, device=dev)

    opts = SfmOptions(min_initial_inliers=60, min_matches=15,
                      init_min_tri_angle_deg=1.0, min_tri_angle_deg=0.8,
                      lm_capacity=8192)
    scene, stats = run_sfm(xy, desc, mask, image_size=(320, 240),
                           options=opts, verbose=True, device=dev)

    valid = scene.pose_valid.cpu().numpy()
    est = scene.pose.cpu().numpy()[valid]
    gt = poses_gt[valid]
    c_est = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("nij,ni->nj", gt[:, :3, :3], gt[:, :3, 3])
    print(f"ATE RMSE: {ate_rmse(c_est, c_gt):.4f} "
          f"(trajectory span ~{np.ptp(c_gt, 0).max():.2f})")

    names = [f"frame{i:03d}.png" for i in np.nonzero(valid)[0]]
    k = scene.intr.cpu().numpy()
    save_positions(out_dir / "transform.json", names, est,
                   320, 240, float(k[2]), float(k[3]), float(k[0]), float(k[1]))
    n_pts = export_cloud(out_dir / "cloud.ply", scene)
    export_trajectory(out_dir / "trajectory.ply", scene)
    print(f"wrote transform.json, cloud.ply ({n_pts} points), trajectory.ply "
          f"to {out_dir}")


if __name__ == "__main__":
    main()
