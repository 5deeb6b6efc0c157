"""The registration sweep: next-best-view selection, PnP registration,
two-pass triangulation and windowed local bundle adjustment, frame after
frame (port of eacham_tpu/sfm/device_loop.py).

The reference compiles the whole loop into one on-device program; here it
is a host loop over tensor ops whose state stays on the device. Per
registration the host reads back the candidate (frames and score), its PnP
inlier count and, when a local BA is due, the window's landmark count and
one flag per LM iteration; each read is counted (``utils.timer.readback``).

A registration's three fixed-shape stages (``pnp_stage``, ``set_pose`` with
the first triangulation pass, the second pass) run through ``graphs.staged``,
the frame as a device tensor, so that every frame replays one graph.

Each iteration's stages are spans of ``utils.timer`` (recorded while a
profiler runs): ``sfm.device_loop.next_view``, ``.pnp``, ``.triangulate``
(both passes; the first holds ``set_pose``) and ``.local_ba`` (the window
build, ``refine_ba`` and the scatters; its count ``iterations``).
``registered`` and ``pnp_failed`` are counted on the caller's span
(``sfm.device_loop`` in ``sfm/pipeline.py``).
"""

from __future__ import annotations

import torch

from eacham_tpu_torch import graphs
from eacham_tpu_torch.ba.core import BAConfig, refine_ba
from eacham_tpu_torch.geometry.ransac import draw_uniforms
from eacham_tpu_torch.sfm.pipeline import (
    local_neighbors, next_best_view, pnp_register, set_pose, sync_ranks,
)
from eacham_tpu_torch.sfm.scene import (
    Scene, ba_problem_windowed, scatter_window_points, scatter_window_poses,
)
from eacham_tpu_torch.sfm.triangulate import triangulate_frame
from eacham_tpu_torch.utils import timer

_POSED = ("pose", "pose_valid")
_MAPPED = ("points", "lm_valid", "n_landmarks", "kp2lm")


def pnp_stage(t: dict, n_hyp: int, pair_only: bool) -> dict:
    """``pnp_register`` of frame ``t["cur"]`` (prev ``t["prev"]``, its pair
    rows ``t["pair_rows"]``, RANSAC uniforms ``t["u"]``) on the scene whose
    fields ``t`` holds. Returns {"T", "n_inl"}."""
    T, n_inl = pnp_register(Scene(*(t[f] for f in Scene._fields)), t["prev"], t["cur"],
                            t["pair_rows"], threshold=4.0, n_hyp=n_hyp, pair_only=pair_only,
                            uniforms=t["u"])
    return {"T": T, "n_inl": n_inl}


def triangulate_stage(t: dict, min_observers: int, max_repr_error: float,
                      min_tri_angle: float, max_observers: int) -> dict:
    """``triangulate_frame`` of frame ``t["cur"]`` on the scene whose fields
    ``t`` holds, after ``set_pose`` at ``t["T"]`` where ``t`` has one.
    Returns the fields it wrote."""
    scene = Scene(*(t[f] for f in Scene._fields))
    posed = "T" in t
    if posed:
        scene = set_pose(scene, t["cur"], t["T"])
    scene, _, _ = triangulate_frame(scene, t["cur"], t["pair_rows"], min_observers,
                                    max_repr_error, min_tri_angle, max_observers=max_observers)
    return {f: getattr(scene, f) for f in (_POSED if posed else ()) + _MAPPED}


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
    local_ba: dict | None = None,
):
    """Register up to ``max_steps`` frames. Returns (scene, excluded,
    n_registered, more), ``more`` meaning that the loop stopped on the step
    limit with candidates remaining.

    Per iteration: next_best_view -> PnP (gate: ``min_pnp_inliers``) ->
    triangulate(2 observers) -> local BA on every ``ba_every``-th
    iteration (gate: ``min_ba_landmarks``) -> triangulate(3 observers). A
    frame whose PnP fails is marked excluded and never tried again.
    ``local_ba``: a dict whose ``calls`` and ``iterations`` each local BA
    run adds to.
    """
    N, K = scene.kp_mask.shape
    dev = scene.kp_mask.device
    limit = N if max_steps is None else min(max_steps, N)
    n_reg, it, has = 0, 0, True
    while it < limit:
        with timer.span("sfm.device_loop.next_view"):
            view = torch.stack(next_best_view(scene, excluded))
            prev, cur, score = (int(v) for v in timer.readback(torch.Tensor.tolist, view))
        has = score >= 0
        if not has:
            break
        # the frame as the stages take it: device tensors, and its pair rows
        frame = {"cur": view[1:2], "pair_rows": fp_tbl[cur]}
        with timer.span("sfm.device_loop.pnp"):
            u = draw_uniforms(generator, (), n_hyp_pnp, K, dev)
            out = graphs.staged(pnp_stage,
                                {**scene._asdict(), **frame, "prev": view[0:1], "u": u},
                                n_hyp=n_hyp_pnp, pair_only=pnp_pair_only)
            n_inl = timer.readback(int, out["n_inl"])
        if n_inl >= min_pnp_inliers:
            scene = _register(scene, cur, frame, out["T"], it, max_repr_error, min_tri_angle,
                              min_ba_landmarks, ba_cfg, max_observers, ba_max_cams,
                              ba_max_obs, ba_max_lms, ba_every, ba_free_span, local_ba)
            n_reg += 1
            timer.add("registered")
        else:
            excluded = excluded.clone()
            excluded[cur] = True
            timer.add("pnp_failed")
        it += 1
    return scene, excluded, n_reg, has and it >= limit


def _register(scene, cur, frame, T, it, max_repr_error, min_tri_angle, min_ba_landmarks,
              ba_cfg, max_observers, ba_max_cams, ba_max_obs, ba_max_lms, ba_every,
              ba_free_span, local_ba):
    """Take frame ``cur`` (``frame``: the stages' form of it) into the map
    with pose ``T``."""
    tri = dict(max_repr_error=max_repr_error, min_tri_angle=min_tri_angle,
               max_observers=max_observers)
    with timer.span("sfm.device_loop.triangulate"):
        scene = scene._replace(**graphs.staged(
            triangulate_stage, {**scene._asdict(), **frame, "T": T}, min_observers=2, **tri))
    # local BA is a large share of the sweep's cost; ba_every > 1 spreads it over
    # registrations, and the frames it skips are refined by the next window
    # that holds them and by the interim and global BA
    if it % ba_every == 0:
        with timer.span("sfm.device_loop.local_ba") as sp:
            # the local problem is compacted to a fixed window: the new frame's
            # neighbourhood is small at any scene size
            nb = local_neighbors(scene, cur)
            prob, cam_list, cam_on, lm_list, lm_on = ba_problem_windowed(
                scene, nb, max_cams=ba_max_cams, max_obs=ba_max_obs, cur=cur,
                max_lms=ba_max_lms, free_span=ba_free_span)
            if timer.readback(int, prob.pt_in_ba.sum()) >= min_ba_landmarks:
                poses, points, intr, info = refine_ba(prob, ba_cfg)
                sp.add("iterations", info["iterations"])
                if local_ba is not None:
                    local_ba["calls"] += 1
                    local_ba["iterations"] += info["iterations"]
                scene = scatter_window_poses(scene, cam_list, cam_on, poses)
                scene = scatter_window_points(scene, lm_list, lm_on, points)
                scene = scene._replace(intr=intr)
    with timer.span("sfm.device_loop.triangulate"):
        scene = scene._replace(**graphs.staged(
            triangulate_stage, {**scene._asdict(), **frame}, min_observers=3, **tri))
    return scene


def registration_sweep(scene: Scene, excluded: torch.Tensor, fp_tbl: torch.Tensor,
                       generator: torch.Generator | None, max_repr_error: float,
                       min_tri_angle: float, segment: int = 0, on_segment=None, mesh=None,
                       **kw):
    """Register every reachable frame. Returns (scene, excluded,
    n_registered).

    ``segment`` > 0 splits the sweep into runs of that many iterations;
    ``on_segment(scene) -> scene`` runs between segments (not after the
    last one): the hook for interim global BA, which arrests the pose drift
    that a purely local-window sweep accumulates over hundreds of frames.
    The local-BA cadence ``ba_every`` counts iterations within a segment.

    Under a ``mesh`` of several ranks every rank sweeps on its own, and
    after each segment all take rank 0's scene state, ``excluded`` and
    decision to go on (``pipeline.sync_ranks``), so that all enter
    ``on_segment``'s collectives together; ``n_registered`` is rank 0's.
    """
    N = scene.kp_mask.shape[0]
    if segment <= 0 or segment >= N:
        scene, excluded, n_reg, _ = registration_sweep_step(
            scene, excluded, fp_tbl, generator, max_repr_error, min_tri_angle, **kw)
        scene, excluded, (n_reg,) = sync_ranks(mesh, scene, excluded, n_reg)
        return scene, excluded, n_reg
    total = 0
    for _ in range(0, N + segment, segment):
        scene, excluded, n_reg, more = registration_sweep_step(
            scene, excluded, fp_tbl, generator, max_repr_error, min_tri_angle,
            max_steps=segment, **kw)
        scene, excluded, (n_reg, more) = sync_ranks(mesh, scene, excluded, n_reg, more)
        total += n_reg
        if not more:
            break
        if on_segment is not None:
            scene = on_segment(scene)
    return scene, excluded, total
