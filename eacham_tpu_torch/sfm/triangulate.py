"""Per-frame multi-view triangulation with landmark merge and relink
(port of eacham_tpu/sfm/triangulate.py).

  * merge: a keypoint of the new frame links to an existing landmark when
    some matched neighbour keypoint already carries a landmark with more
    than 2 observers that reprojects into the new frame under the error
    bound; the first such neighbour (lowest frame) wins;
  * otherwise the keypoint's observers across all registered neighbours
    form a track; tracks with >= ``min_observers`` go through
    exhaustive-pair consensus triangulation, capped at ``max_observers``
    observers (earlier frames first);
  * a track is accepted only if every observer is an inlier;
  * accepted points are added to the map and all observers are re-linked,
    overwriting stale links: merges are written first, new landmarks
    after them.

One pass of tensor ops over the [K] keypoints of the frame; nothing is read
back to the host.
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.geometry.camera import project
from eacham_tpu_torch.geometry.triangulation import triangulate_consensus
from eacham_tpu_torch.sfm.matches import observers_of_frame
from eacham_tpu_torch.sfm.scene import Scene, alloc_landmarks, frame_row, lm_observer_counts


def first_true(mask: torch.Tensor, dim: int):
    """(index of the first True along ``dim``, whether there is one); index 0
    where there is none, as an argmax over bools that takes the first
    maximum."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    ramp = torch.arange(n, 0, -1, device=mask.device).view(shape)   # n .. 1
    top = (mask * ramp).amax(dim)
    return torch.where(top > 0, n - top, 0), top > 0


def first_k_true(mask: torch.Tensor, k: int):
    """Slots of the first ``k`` True entries of each row of ``mask`` [M, n],
    in ascending order, then the lowest False slots: what a top-k over 0/1
    keys gives when ties go to the lower index. Returns (idx [M, k], on
    [M, k])."""
    n = mask.shape[1]
    slot = torch.arange(n, device=mask.device)
    key = mask.to(torch.int64) * n + (n - 1 - slot)
    idx = torch.topk(key, k, dim=1).indices
    return idx, torch.gather(mask, 1, idx)


def scatter_last_wins(dst: torch.Tensor, target: torch.Tensor, value: torch.Tensor) -> None:
    """``dst[target] = value`` in place where, of several writers of one
    slot, the last in order wins (a plain indexed store leaves that open on
    the card)."""
    order = torch.arange(target.shape[0], device=target.device)
    last = torch.full_like(dst, -1, dtype=torch.int64).scatter_reduce_(
        0, target, order, "amax")
    wins = last[target] == order
    # losers are sent to their own slot's winner's value: a store of equal values
    dst[target] = torch.where(wins, value, value[torch.clamp(last[target], min=0)])


@torch.no_grad()
def triangulate_frame(scene: Scene, frame: int, pair_rows: torch.Tensor, min_observers: int,
                      max_repr_error: float, min_tri_angle: float, max_observers: int = 12):
    """Triangulate the tracks of ``frame`` (an int, or a one-element index
    tensor on the scene's device) against its registered neighbours
    ``pair_rows`` = frame_pair_table[frame].
    Returns ``(scene, n_merged, n_new)``, the counts as 0-d tensors."""
    N, K = scene.kp_mask.shape
    D = pair_rows.shape[0]
    dev = scene.kp_mask.device
    if not isinstance(frame, torch.Tensor):
        frame = int(frame)

    obs_frame, obs_kp, obs_on = observers_of_frame(
        frame, pair_rows, scene.pair_idx, scene.pair_ok,
        scene.match_ij, scene.valid_ij, scene.match_ji, scene.valid_ji)   # [D], [D, K]
    kp_live = frame_row(scene.kp_mask, frame)
    obs_on = obs_on & scene.pose_valid[obs_frame][:, None] & kp_live[None, :]

    # ---- merge into existing landmarks ----------------------------------------
    counts = lm_observer_counts(scene)                    # [L]
    nb_lm = scene.kp2lm[obs_frame[:, None], obs_kp].long()     # [D, K]
    nb_lm_safe = torch.clamp(nb_lm, min=0)
    cand = obs_on & (nb_lm >= 0) & scene.lm_valid[nb_lm_safe] & (counts[nb_lm_safe] > 2)
    uv_proj, z = project(frame_row(scene.pose, frame), scene.points[nb_lm_safe], scene.intr)
    err = torch.linalg.vector_norm(uv_proj - frame_row(scene.keypoints, frame)[None, :, :],
                                   dim=-1)
    cand = cand & (z > 0.0) & (err < max_repr_error)
    # neighbour slots are in ascending frame order: the first one that qualifies wins
    merge_src, merge_ok = first_true(cand, 0)             # [K]
    self_col = torch.arange(K, device=dev)
    merge_lm = nb_lm_safe[merge_src, self_col]

    # ---- tracks for the rest ---------------------------------------------------
    # the new frame itself observes the track (last slot)
    track_on = torch.cat([obs_on.t(), kp_live[:, None]], dim=1)                 # [K, D+1]
    track_kp = torch.cat([obs_kp.t(), self_col[:, None]], dim=1)
    own = (frame.reshape(1).to(obs_frame.dtype) if isinstance(frame, torch.Tensor)
           else obs_frame.new_full((1,), frame))
    track_frame = torch.cat([obs_frame, own])[None, :].expand(K, D + 1)
    candidate = (~merge_ok) & (track_on.sum(1) >= min_observers)

    # cap the observers of a track, earlier frames first
    sel_idx, sel_on = first_k_true(track_on, min(max_observers, D + 1))
    sel_kp = torch.gather(track_kp, 1, sel_idx)
    sel_frame = torch.gather(track_frame, 1, sel_idx)

    pts, inl, ok = triangulate_consensus(
        scene.pose[sel_frame], scene.keypoints[sel_frame, sel_kp], sel_on,
        scene.intr, max_repr_error, min_tri_angle)
    all_inliers = (inl | ~sel_on).all(1)
    new_ok = candidate & ok & all_inliers
    scene, ids = alloc_landmarks(scene, pts, new_ok)

    # ---- relink: merges first, new landmarks overwrite -------------------------
    pad = torch.cat([scene.kp2lm.reshape(-1), scene.kp2lm.new_zeros(1)])
    dump = N * K
    merge_target = torch.where(merge_ok, frame * K + self_col, dump)
    pad[merge_target] = torch.where(merge_ok, merge_lm, 0).to(pad.dtype)   # distinct slots

    got_id = ids >= 0
    link_on = sel_on & got_id[:, None]
    link_target = torch.where(link_on, sel_frame * K + sel_kp, dump).reshape(-1)
    link_val = torch.where(link_on, ids[:, None], 0).reshape(-1).to(pad.dtype)
    scatter_last_wins(pad, link_target, link_val)
    scene = scene._replace(kp2lm=pad[:-1].reshape(N, K))
    return scene, merge_ok.sum(), got_id.sum()
