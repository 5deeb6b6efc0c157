"""Struct-of-arrays SfM scene state (port of eacham_tpu/sfm/scene.py).

Every container is a padded, statically-shaped tensor with a validity
mask. The observation table that bundle adjustment needs is derived, not
stored: every (frame, keypoint) slot with a landmark link is an
observation, so the functions below that make a BA problem are gathers and
compactions of ``kp2lm``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eacham_tpu_torch.ba.core import BAProblem
from eacham_tpu_torch.utils import timer


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


def frame_row(x: torch.Tensor, frame) -> torch.Tensor:
    """``x[frame]`` for an int ``frame``, or for a one-element int64 tensor
    on ``x``'s device, which indexes with nothing read back to the host (a
    0-d device index is read back first)."""
    if isinstance(frame, torch.Tensor):
        return x[frame.reshape(1)][0]
    return x[frame]


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
    # rejected rows go to a dump row, so no count has to reach the host
    L = scene.lm_capacity
    dst = torch.where(ok, ids, L).long()
    points = torch.cat([scene.points, scene.points.new_zeros((1, 3))])
    points[dst] = new_points.to(points.dtype)
    lm_valid = torch.cat([scene.lm_valid, scene.lm_valid.new_zeros(1)])
    lm_valid.index_fill_(0, dst, True)      # the value is the kernel's argument: no upload
    return scene._replace(
        points=points[:L],
        lm_valid=lm_valid[:L],
        n_landmarks=scene.n_landmarks + ok.sum().to(torch.int32),
    ), ids


def lm_observer_counts(scene: Scene) -> torch.Tensor:
    """[L] float observer count per landmark, from registered frames only."""
    obs_on = (scene.kp2lm >= 0) & scene.kp_mask & scene.pose_valid[:, None]
    L = scene.lm_capacity
    flat_lm = torch.where(obs_on, scene.kp2lm, L).reshape(-1).long()
    # (bincount would read the largest id back to the host first); counted
    # in int32, so that no float sum on the SfM paths depends on the order
    # of the card's atomics
    counts = torch.zeros(L + 1, dtype=torch.int32, device=flat_lm.device)
    counts.scatter_add_(0, flat_lm, torch.ones_like(flat_lm, dtype=torch.int32))
    return counts[:L].float()


def ba_problem_from_scene(scene: Scene, cam_in_ba: torch.Tensor,
                          min_observers: int = 2) -> BAProblem:
    """Materialize the (derived) observation table into a BAProblem over the
    full padded axes: an observation participates when its frame is
    registered, the landmark is valid and has >= ``min_observers``
    registered observers."""
    N, K = scene.kp_mask.shape
    counts = lm_observer_counts(scene)
    obs_cam = torch.arange(N, device=counts.device).repeat_interleave(K)
    lm = scene.kp2lm.reshape(-1).long()
    obs_pt = torch.clamp(lm, min=0)
    obs_mask = ((lm >= 0) & scene.kp_mask.reshape(-1)
                & scene.pose_valid.repeat_interleave(K)
                & (counts[obs_pt] >= min_observers) & scene.lm_valid[obs_pt])
    return BAProblem(
        poses=scene.pose, points=scene.points, intr=scene.intr,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=scene.keypoints.reshape(-1, 2),
        obs_mask=obs_mask, cam_in_ba=cam_in_ba & scene.pose_valid,
        cam_fixed=scene.pose_fixed,
        pt_in_ba=scene.lm_valid & (counts >= min_observers),
        pt_obs_count=torch.clamp(counts, min=1.0))


def ba_problem_counts(scene: Scene, cam_in_ba: torch.Tensor, min_observers: int = 2):
    """(n_obs, n_lms) the BA problem would hold, as 0-d tensors: the host
    reads these two scalars to pick bucketed compact axis sizes before it
    builds the problem."""
    counts = lm_observer_counts(scene)
    in_ba = cam_in_ba & scene.pose_valid
    lm = scene.kp2lm
    lm0 = torch.clamp(lm, min=0).long()
    ok = ((lm >= 0) & scene.kp_mask & in_ba[:, None]
          & (counts[lm0] >= min_observers) & scene.lm_valid[lm0])
    pt = scene.lm_valid & (counts >= min_observers)
    return ok.sum(), pt.sum()


def _compact_mask(mask: torch.Tensor, m: int):
    """Indices of the first ``m`` True entries of a flat bool mask, in order
    (cumsum + scatter through a dump slot).

    Returns ``(idx [m] int64, clamped to 0 where off; on [m] bool; pos [n]
    int64, the destination slot per entry, -1 where not taken)``.
    """
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    take = mask & (pos < m)
    pos = torch.where(take, pos, -1)
    dst = torch.where(take, pos, m)                       # m = dump slot
    idx = torch.full((m + 1,), -1, dtype=torch.int64, device=mask.device)
    # destinations of taken entries are distinct; only the dump slot is
    # written more than once, and it is cut off
    idx[dst] = torch.arange(n, device=mask.device)
    idx = idx[:-1]
    return torch.clamp(idx, min=0), idx >= 0, pos


def ba_problem_windowed(scene: Scene, cam_in_ba: torch.Tensor, max_cams: int = 16,
                        max_obs: int = 16384, min_observers: int = 2, cur=None,
                        max_lms: int | None = None, free_span: int = 0):
    """Compact local-BA problem: participating cameras gathered into a
    [max_cams] window, their observations into [max_obs] slots, and the
    landmark axis into [max_lms] rows (default min(max_obs, L)).

    When the neighbourhood exceeds ``max_cams`` the current frame ``cur`` is
    kept first and the other cameras are taken in ascending index. With
    ``free_span > 0`` window cameras more than ``free_span`` ids from
    ``cur`` are frozen, which pins the window's similarity gauge.

    Returns (BAProblem, cam_list [max_cams], cam_on [max_cams] bool,
    lm_list [max_lms], lm_on [max_lms] bool); write back with
    ``scatter_window_poses`` / ``scatter_window_points``.
    """
    N, K = scene.kp_mask.shape
    L = scene.lm_capacity
    dev = scene.kp_mask.device
    max_cams = min(max_cams, N)
    max_obs = min(max_obs, max_cams * K)   # a C-cam window holds <= C*K obs
    counts = lm_observer_counts(scene)

    # key 2 for the just-registered frame, 1 for neighbours, 0 otherwise;
    # equal keys go to the lower index, as the reference's top_k breaks
    # ties (torch.topk promises no order among equal values)
    frames = torch.arange(N, device=dev)
    sel_key = (cam_in_ba & scene.pose_valid).to(torch.int64)
    if cur is not None:
        sel_key = sel_key + sel_key * (frames == cur)
    order = torch.topk(sel_key * N + (N - 1 - frames), max_cams).indices
    cam_list = order
    cam_on = sel_key[cam_list] > 0
    C = max_cams

    # only the window's rows [C, K] are searched for observations
    lm = scene.kp2lm[cam_list].reshape(-1).long()        # [C*K]
    lm0 = torch.clamp(lm, min=0)
    lm_ok = scene.lm_valid[lm0] & (counts[lm0] >= min_observers)
    in_window = ((lm >= 0) & (scene.kp_mask[cam_list] & cam_on[:, None]).reshape(-1) & lm_ok)
    uv_window = scene.keypoints[cam_list].reshape(-1, 2)
    if max_obs >= C * K:
        # the obs axis is the window table itself: no compaction
        obs_cam = torch.arange(C, device=dev).repeat_interleave(K)
        obs_pt = torch.where(in_window, lm, 0)
        obs_uv = uv_window
        o_mask = in_window
    else:
        pick, o_mask, _ = _compact_mask(in_window, max_obs)
        obs_cam = pick // K
        obs_pt = torch.where(o_mask, lm[pick], 0)
        obs_uv = uv_window[pick]

    seen = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    timer.add("readbacks")          # a host scalar written to the card waits for it
    seen[torch.where(o_mask, obs_pt, L)] = True
    pt_in_ba = scene.lm_valid & (counts >= min_observers) & seen[:-1]

    max_lms = min(max_obs, L) if max_lms is None else min(max_lms, L)
    lm_list, lm_on, lm_remap = _compact_mask(pt_in_ba, max_lms)
    obs_pt_w = lm_remap[obs_pt]
    o_mask = o_mask & (obs_pt_w >= 0)
    obs_pt_w = torch.clamp(obs_pt_w, min=0)

    cam_fixed = scene.pose_fixed[cam_list] | (~cam_on)
    if free_span > 0 and cur is not None:
        cam_fixed = cam_fixed | ((cam_list - cur).abs() > free_span)
    prob = BAProblem(
        poses=scene.pose[cam_list], points=scene.points[lm_list], intr=scene.intr,
        obs_cam=obs_cam, obs_pt=obs_pt_w, obs_uv=obs_uv, obs_mask=o_mask,
        cam_in_ba=cam_on, cam_fixed=cam_fixed, pt_in_ba=lm_on,
        pt_obs_count=torch.clamp(counts[lm_list], min=1.0))
    return prob, cam_list, cam_on, lm_list, lm_on


def scatter_window_poses(scene: Scene, cam_list, cam_on, new_poses) -> Scene:
    """Write optimized window poses back into the scene (``cam_list`` holds
    distinct frames; slots that are off keep the scene's pose)."""
    merged = torch.where(cam_on[:, None, None], new_poses, scene.pose[cam_list])
    return scene._replace(pose=scene.pose.index_put((cam_list,), merged))


def scatter_window_points(scene: Scene, lm_list, lm_on, new_points) -> Scene:
    """Write optimized window landmarks back into the scene. Slots that are
    off all carry index 0, so they are sent to a dump row instead of racing
    with landmark 0's own slot."""
    L = scene.lm_capacity
    pad = torch.cat([scene.points, scene.points.new_zeros((1, 3))])
    pad[torch.where(lm_on, lm_list, L)] = new_points.to(pad.dtype)
    return scene._replace(points=pad[:L])
