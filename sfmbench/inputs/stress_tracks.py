"""``scripts/stress_100.py``'s tracks: 100 frames x 1024 synthetic tracks
handed in as keypoints and descriptors, with no images and no frontend.

A frozen copy of ``chip_smoke.stress_world`` (the script's generator, draw
for draw); a test holds it equal to that function. Keypoint slot p of every
frame observes world point p, so the tracks are the ground truth of every
match.
"""

from __future__ import annotations

import numpy as np


def stress_world(n_frames: int = 100, n_pts: int = 1024, seed: int = 0):
    """Returns (keypoints [n, p, 2], descriptors [n, p, 256], mask [n, p],
    world->camera poses [n, 4, 4], intrinsics [4])."""
    rng = np.random.default_rng(seed)
    f = 600.0
    pts = rng.uniform(-2, 2, (n_pts, 3))
    pts[:, 2] += 6.0
    intr = np.array([f, f, 320., 240.], np.float32)
    poses = []
    for i in range(n_frames):
        a = 0.012 * i
        c, s = np.cos(a), np.sin(a)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        T[:3, 3] = [0.05 * (i - n_frames / 2), 0.01 * i, 0.02 * i]
        poses.append(T)
    poses = np.stack(poses).astype(np.float32)
    pc = np.einsum("nij,pj->npi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([f * pc[..., 0] / pc[..., 2] + 320,
                   f * pc[..., 1] / pc[..., 2] + 240], -1)
    uv = (uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
    mask = ((uv[..., 0] >= 0) & (uv[..., 0] < 640) &
            (uv[..., 1] >= 0) & (uv[..., 1] < 480) & (pc[..., 2] > 0.1))
    desc = rng.normal(size=(n_pts, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    desc = np.broadcast_to(desc, (n_frames, n_pts, 256)).copy()
    corrupt = rng.random((n_frames, n_pts)) < 0.10
    nz = rng.normal(size=(n_frames, n_pts, 256)).astype(np.float32)
    nz /= np.linalg.norm(nz, axis=-1, keepdims=True)
    desc[corrupt] = nz[corrupt]
    return uv, desc, mask, poses, intr


def make(params: dict, seed: int) -> dict:
    """``params``: frames, points, width, height. Returns keypoints,
    descriptors and mask (the program's input), poses and intr."""
    if (params["width"], params["height"]) != (640, 480):
        raise ValueError("stress_world draws its tracks at 640x480")
    uv, desc, mask, poses, intr = stress_world(params["frames"], params["points"], seed)
    return {"keypoints": uv, "descriptors": desc, "mask": mask, "poses": poses,
            "intr": intr, "size": (params["width"], params["height"])}
