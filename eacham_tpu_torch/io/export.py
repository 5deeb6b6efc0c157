"""Offline reconstruction export: PLY point cloud + camera trajectory
(port of eacham_tpu/io/export.py).

Replaces the reference's live Pangolin rendering (apps/sfm/view/
GraphView.h:27-88 camera frusta + trajectory, MapView.h:28-72 landmark
cloud filtered by validity and min-observers) with persisted artifacts:
a standard PLY any viewer opens, and a trajectory PLY of camera centers
(first camera colored red, others green — GraphView.h:36-41's scheme).
The scene's tensors are read back to the host once per function; the files
are byte for byte those of the reference on the same scene.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from eacham_tpu_torch.device import to_numpy
from eacham_tpu_torch.sfm.scene import Scene, lm_observer_counts


def _write_ply(path: Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")


def export_cloud(
    path: str | Path,
    scene: Scene,
    min_observers: int = 2,
    color: np.ndarray | None = None,   # [L, 3] uint8 optional
) -> int:
    """Write valid landmarks with >= min_observers to PLY (MapView.h:28-46's
    filter). Returns the number of points written."""
    counts = to_numpy(lm_observer_counts(scene))
    valid = to_numpy(scene.lm_valid) & (counts >= min_observers)
    pts = to_numpy(scene.points)[valid]
    if color is None:
        rgb = np.full((len(pts), 3), 200, np.uint8)
    else:
        rgb = np.asarray(color)[valid]
    _write_ply(Path(path), pts, rgb)
    return int(valid.sum())


def landmark_colors(scene: Scene, images: np.ndarray) -> np.ndarray:
    """[L, 3] uint8 per-landmark colors sampled at the first observing
    keypoint (the reference stores a color per MapPointData, Map.h:17-22;
    colors are grabbed from the host image batch — grayscale intensity
    replicated to RGB, or true RGB when a [N, H, W, 3] batch is given)."""
    images = to_numpy(images)
    kp2lm = to_numpy(scene.kp2lm)
    kps = to_numpy(scene.keypoints)
    N, K = kp2lm.shape
    L = scene.lm_capacity
    colors = np.full((L, 3), 200, np.uint8)
    has = np.zeros(L, bool)
    rgb = images.ndim == 4
    H, W = images.shape[1], images.shape[2]
    for n in range(N):
        lm = kp2lm[n]
        pick = (lm >= 0) & (~has[np.maximum(lm, 0)])
        for k in np.nonzero(pick)[0]:
            x = int(np.clip(kps[n, k, 0], 0, W - 1))
            y = int(np.clip(kps[n, k, 1], 0, H - 1))
            v = images[n, y, x]
            colors[lm[k]] = (
                (np.asarray(v) * 255).astype(np.uint8)
                if rgb else np.full(3, int(v * 255), np.uint8)
            )
            has[lm[k]] = True
    return colors


def export_trajectory(path: str | Path, scene: Scene) -> int:
    """Write registered camera centers to PLY; first camera red, rest green
    (GraphView.h:36-41)."""
    valid = to_numpy(scene.pose_valid)
    poses = to_numpy(scene.pose)[valid]
    centers = -np.einsum("nij,ni->nj", poses[:, :3, :3], poses[:, :3, 3])
    rgb = np.tile(np.array([[0, 200, 0]], np.uint8), (len(centers), 1))
    if len(rgb):
        rgb[0] = (220, 0, 0)
    _write_ply(Path(path), centers, rgb)
    return int(valid.sum())
