"""Struct-of-arrays SfM scene state (port of eacham_tpu/sfm/scene.py).

Every container is a padded, statically-shaped tensor with a validity
mask. The BA-problem builders of the reference come with the BA port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    """Whole-reconstruction state. N frames, K kps/frame, P pairs, L landmarks."""

    # frames
    keypoints: torch.Tensor    # [N, K, 2] pixel coords
    kp_mask: torch.Tensor      # [N, K] bool
    pose: torch.Tensor         # [N, 4, 4] world->cam
    pose_valid: torch.Tensor   # [N] bool — registered frames
    pose_fixed: torch.Tensor   # [N] bool — gauge-fixed frames
    # match graph (undirected edges stored once with both direction tables)
    pair_idx: torch.Tensor     # [P, 2] int32 (i, j), i < j
    pair_ok: torch.Tensor      # [P] bool — edge survived the match gate
    match_ij: torch.Tensor     # [P, K] int32 — kp of frame i -> kp of frame j
    valid_ij: torch.Tensor     # [P, K] bool
    match_ji: torch.Tensor     # [P, K] int32 — kp of frame j -> kp of frame i
    valid_ji: torch.Tensor     # [P, K] bool
    # landmarks
    points: torch.Tensor       # [L, 3]
    lm_valid: torch.Tensor     # [L] bool
    lm_two_view: torch.Tensor  # [L] bool — seeded by the init pair
    n_landmarks: torch.Tensor  # [] int32 allocation counter
    kp2lm: torch.Tensor        # [N, K] int32 landmark id per keypoint, -1 = none
    # shared camera
    intr: torch.Tensor         # [4] fx fy cx cy

    @property
    def n_frames(self) -> int:
        return self.keypoints.shape[0]

    @property
    def n_kps(self) -> int:
        return self.keypoints.shape[1]

    @property
    def lm_capacity(self) -> int:
        return self.points.shape[0]


def make_scene(keypoints, kp_mask, pair_idx, pair_ok, match_ij, valid_ij,
               match_ji, valid_ji, intr, lm_capacity: int | None = None) -> Scene:
    N, K = kp_mask.shape
    if lm_capacity is None:
        lm_capacity = N * K
    dt, dev = keypoints.dtype, keypoints.device
    return Scene(
        keypoints=keypoints,
        kp_mask=kp_mask,
        pose=torch.eye(4, dtype=dt, device=dev).repeat(N, 1, 1),
        pose_valid=torch.zeros(N, dtype=torch.bool, device=dev),
        pose_fixed=torch.zeros(N, dtype=torch.bool, device=dev),
        pair_idx=pair_idx,
        pair_ok=pair_ok,
        match_ij=match_ij,
        valid_ij=valid_ij,
        match_ji=match_ji,
        valid_ji=valid_ji,
        points=torch.zeros((lm_capacity, 3), dtype=dt, device=dev),
        lm_valid=torch.zeros(lm_capacity, dtype=torch.bool, device=dev),
        lm_two_view=torch.zeros(lm_capacity, dtype=torch.bool, device=dev),
        n_landmarks=torch.zeros((), dtype=torch.int32, device=dev),
        kp2lm=torch.full((N, K), -1, dtype=torch.int32, device=dev),
        intr=intr,
    )


def pair_id_table(pair_idx: np.ndarray, n_frames: int) -> np.ndarray:
    """Host-side [N, N] lookup: pair_id[i, j] = row of (i, j) in pair_idx
    (symmetric), -1 when the frames share no edge slot."""
    tbl = np.full((n_frames, n_frames), -1, np.int32)
    pi = np.asarray(pair_idx)
    tbl[pi[:, 0], pi[:, 1]] = np.arange(pi.shape[0], dtype=np.int32)
    tbl[pi[:, 1], pi[:, 0]] = np.arange(pi.shape[0], dtype=np.int32)
    return tbl


def frame_pair_table(pair_idx: np.ndarray, n_frames: int,
                     bucket: int = 8, d_min: int = 16) -> np.ndarray:
    """Host-side degree-compacted adjacency: [N, D] pair rows touching each
    frame (-1 padded), neighbors in ascending frame order; D is the max
    degree rounded up to ``bucket`` (>= ``d_min``)."""
    pi = np.asarray(pair_idx)
    row_ids = np.arange(pi.shape[0], dtype=np.int32)
    keep = pi[:, 0] != pi[:, 1]     # drop (0, 0) bucket-padding dummy rows
    pi, row_ids = pi[keep], row_ids[keep]
    deg = np.zeros((n_frames,), np.int64)
    np.add.at(deg, pi[:, 0], 1)
    np.add.at(deg, pi[:, 1], 1)
    D = max(d_min, int(deg.max()) if deg.size else 0)
    D = ((D + bucket - 1) // bucket) * bucket
    tbl = np.full((n_frames, D), -1, np.int32)
    frames = np.concatenate([pi[:, 0], pi[:, 1]])
    nbrs = np.concatenate([pi[:, 1], pi[:, 0]])
    rows = np.concatenate([row_ids, row_ids])
    order = np.lexsort((nbrs, frames))
    frames, rows = frames[order], rows[order]
    slot = np.arange(len(frames)) - np.searchsorted(frames, frames)
    tbl[frames, slot] = rows
    return tbl


def alloc_landmarks(scene: Scene, new_points: torch.Tensor, new_ok: torch.Tensor):
    """Allocate landmark slots for ``new_ok`` rows of ``new_points``, ids
    handed out compactly from the allocation counter.

    Returns ``(scene, ids [M] int32)``, ids[m] = -1 where ~new_ok or the
    capacity was exceeded.
    """
    offs = torch.cumsum(new_ok.to(torch.int32), 0, dtype=torch.int32) - 1
    ids = scene.n_landmarks + offs
    ok = new_ok & (ids < scene.lm_capacity)
    ids = torch.where(ok, ids, -1)
    sel = ids[ok].long()
    points = scene.points.clone()
    points[sel] = new_points[ok].to(points.dtype)
    lm_valid = scene.lm_valid.clone()
    lm_valid[sel] = True
    return scene._replace(
        points=points,
        lm_valid=lm_valid,
        n_landmarks=scene.n_landmarks + ok.sum().to(torch.int32),
    ), ids
