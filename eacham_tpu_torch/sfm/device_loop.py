"""The registration sweep: next-best-view selection, PnP registration,
two-pass triangulation and windowed local bundle adjustment, frame after
frame (port of eacham_tpu/sfm/device_loop.py).

The reference compiles the whole loop into one on-device program; here it
is a host loop over tensor ops whose state stays on the device. Per
registration the host reads back the candidate (frames and score), its PnP
inlier count and, when a local BA is due, the window's landmark count and
one flag per LM iteration.
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.ba.core import BAConfig, refine_ba
from eacham_tpu_torch.sfm.pipeline import (
    local_neighbors, next_best_view, pnp_register, set_pose,
)
from eacham_tpu_torch.sfm.scene import (
    Scene, ba_problem_windowed, scatter_window_points, scatter_window_poses,
)
from eacham_tpu_torch.sfm.triangulate import triangulate_frame


@torch.no_grad()
def registration_sweep_step(
    scene: Scene,
    excluded: torch.Tensor,      # [N] bool
    fp_tbl: torch.Tensor,        # [N, D] frame_pair_table
    generator: torch.Generator | None,
    max_repr_error: float,
    min_tri_angle: float,
    min_pnp_inliers: int = 15,
    min_ba_landmarks: int = 50,
    ba_cfg: BAConfig = BAConfig(),
    max_observers: int = 12,
    n_hyp_pnp: int = 512,
    pnp_pair_only: bool = False,
    ba_max_cams: int = 16,
    ba_max_obs: int = 16384,
    ba_max_lms: int | None = None,
    max_steps: int | None = None,
    ba_every: int = 1,
    ba_free_span: int = 0,
):
    """Register up to ``max_steps`` frames. Returns (scene, excluded,
    n_registered, more), ``more`` meaning that the loop stopped on the step
    limit with candidates remaining.

    Per iteration: next_best_view -> PnP (gate: ``min_pnp_inliers``) ->
    triangulate(2 observers) -> local BA on every ``ba_every``-th
    iteration (gate: ``min_ba_landmarks``) -> triangulate(3 observers). A
    frame whose PnP fails is marked excluded and never tried again.
    """
    N = scene.kp_mask.shape[0]
    limit = N if max_steps is None else min(max_steps, N)
    n_reg, it, has = 0, 0, True
    while it < limit:
        prev, cur, score = (int(v) for v in torch.stack(next_best_view(scene, excluded)).tolist())
        has = score >= 0
        if not has:
            break
        T, n_inl = pnp_register(scene, prev, cur, fp_tbl[cur], generator,
                                threshold=4.0, n_hyp=n_hyp_pnp, pair_only=pnp_pair_only)
        if int(n_inl) >= min_pnp_inliers:
            scene = _register(scene, cur, T, fp_tbl[cur], it, max_repr_error, min_tri_angle,
                              min_ba_landmarks, ba_cfg, max_observers, ba_max_cams,
                              ba_max_obs, ba_max_lms, ba_every, ba_free_span)
            n_reg += 1
        else:
            excluded = excluded.clone()
            excluded[cur] = True
        it += 1
    return scene, excluded, n_reg, has and it >= limit


def _register(scene, cur, T, pid_row, it, max_repr_error, min_tri_angle, min_ba_landmarks,
              ba_cfg, max_observers, ba_max_cams, ba_max_obs, ba_max_lms, ba_every,
              ba_free_span):
    """Take frame ``cur`` into the map with pose ``T``."""
    scene = set_pose(scene, cur, T)
    scene, _, _ = triangulate_frame(scene, cur, pid_row, 2, max_repr_error, min_tri_angle,
                                    max_observers=max_observers)
    # local BA is a large share of the sweep's cost; ba_every > 1 spreads it over
    # registrations, and the frames it skips are refined by the next window
    # that holds them and by the interim and global BA
    if it % ba_every == 0:
        # the local problem is compacted to a fixed window: the new frame's
        # neighbourhood is small at any scene size
        nb = local_neighbors(scene, cur)
        prob, cam_list, cam_on, lm_list, lm_on = ba_problem_windowed(
            scene, nb, max_cams=ba_max_cams, max_obs=ba_max_obs, cur=cur,
            max_lms=ba_max_lms, free_span=ba_free_span)
        if int(prob.pt_in_ba.sum()) >= min_ba_landmarks:
            poses, points, intr, _ = refine_ba(prob, ba_cfg)
            scene = scatter_window_poses(scene, cam_list, cam_on, poses)
            scene = scatter_window_points(scene, lm_list, lm_on, points)
            scene = scene._replace(intr=intr)
    scene, _, _ = triangulate_frame(scene, cur, pid_row, 3, max_repr_error, min_tri_angle,
                                    max_observers=max_observers)
    return scene


def registration_sweep(scene: Scene, excluded: torch.Tensor, fp_tbl: torch.Tensor,
                       generator: torch.Generator | None, max_repr_error: float,
                       min_tri_angle: float, segment: int = 0, on_segment=None, **kw):
    """Register every reachable frame. Returns (scene, excluded,
    n_registered).

    ``segment`` > 0 splits the sweep into runs of that many iterations;
    ``on_segment(scene) -> scene`` runs between segments (not after the
    last one): the hook for interim global BA, which arrests the pose drift
    that a purely local-window sweep accumulates over hundreds of frames.
    The local-BA cadence ``ba_every`` counts iterations within a segment.
    """
    N = scene.kp_mask.shape[0]
    if segment <= 0 or segment >= N:
        scene, excluded, n_reg, _ = registration_sweep_step(
            scene, excluded, fp_tbl, generator, max_repr_error, min_tri_angle, **kw)
        return scene, excluded, n_reg
    total = 0
    for _ in range(0, N + segment, segment):
        scene, excluded, n_reg, more = registration_sweep_step(
            scene, excluded, fp_tbl, generator, max_repr_error, min_tri_angle,
            max_steps=segment, **kw)
        total += n_reg
        if not more:
            break
        if on_segment is not None:
            scene = on_segment(scene)
    return scene, excluded, total
