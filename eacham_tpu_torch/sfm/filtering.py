"""Observation and landmark outlier pruning (port of
eacham_tpu/sfm/filtering.py): drop observations whose reprojection error
exceeds a threshold or that fall behind their camera, and invalidate
landmarks left with fewer than two registered observers. Run around global
BA; one projection pass."""

from __future__ import annotations

import torch

from eacham_tpu_torch.geometry.camera import project
from eacham_tpu_torch.sfm.scene import Scene, lm_observer_counts


@torch.no_grad()
def prune_observations(scene: Scene, max_repr_error: float = 8.0):
    """Returns (scene, n_dropped_obs, n_invalidated_landmarks), the counts
    as 0-d tensors."""
    lm = scene.kp2lm
    lm_safe = torch.clamp(lm, min=0).long()
    linked = (lm >= 0) & scene.kp_mask & scene.pose_valid[:, None]
    uv_proj, z = project(scene.pose[:, None], scene.points[lm_safe], scene.intr)   # [N, K, 2]
    err = torch.linalg.vector_norm(uv_proj - scene.keypoints, dim=-1)
    bad = linked & ((err > max_repr_error) | (z <= 0.0))

    kp2lm = torch.where(bad, -1, scene.kp2lm)
    scene = scene._replace(kp2lm=kp2lm)
    counts = lm_observer_counts(scene)
    was_valid = scene.lm_valid
    lm_valid = was_valid & (counts >= 2)
    # unlink keypoints whose landmark just died
    dead = (kp2lm >= 0) & (~lm_valid[torch.clamp(kp2lm, min=0).long()])
    scene = scene._replace(kp2lm=torch.where(dead, -1, kp2lm), lm_valid=lm_valid)
    return scene, bad.sum(), (was_valid & ~lm_valid).sum()
