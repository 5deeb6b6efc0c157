"""Two-view initialization: E-vs-H model selection, pose recovery, seeding
(port of eacham_tpu/sfm/twoview.py).

Every function batches over leading axes: ``find_best_pair`` evaluates a
chunk of candidate pairs, both directions, in one pass and stops at the
first pair whose both directions clear ``min_initial_inliers``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from eacham_tpu_torch.geometry.camera import pixel_to_normalized, reprojection_error
from eacham_tpu_torch.geometry.epipolar import estimate_essential, recover_pose
from eacham_tpu_torch.geometry.homography import decompose_homography, estimate_homography
from eacham_tpu_torch.geometry.ransac import take_along
from eacham_tpu_torch.geometry.se3 import rt_to_mat, transform_points
from eacham_tpu_torch.geometry.triangulation import triangulate_dlt, triangulation_angle


class TwoViewResult(NamedTuple):
    T: torch.Tensor                # [..., 4, 4] world->cam of view 2 (view 1 = identity)
    points: torch.Tensor           # [..., K, 3] triangulated points in view-1 frame
    point_ok: torch.Tensor         # [..., K] bool — survived all filters
    n_good: torch.Tensor           # [...] int
    used_homography: torch.Tensor  # [...] bool


def triangulate_filter(T, xy1, xy2, uv1, uv2, valid, intr, max_err, min_angle):
    """DLT-triangulate all matches against (I, T) and apply the
    acceptance filters: positive depth in both views, reprojection error
    under ``max_err`` in both, parallax at least ``min_angle``.

    T [..., 4, 4]; points [..., K, 2]."""
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    Tb = T[..., None, :, :]
    pts = triangulate_dlt(eye, Tb, xy1, xy2)          # [..., K, 3] (= cam-1 frame)
    pc2 = transform_points(Tb, pts)
    err1 = reprojection_error(uv1, pts, intr)
    err2 = reprojection_error(uv2, pc2, intr)
    ang = triangulation_angle(eye, Tb, pts)
    ok = (valid & (pts[..., 2] > 0.0) & (pc2[..., 2] > 0.0)
          & (err1 < max_err) & (err2 < max_err) & (ang >= min_angle))
    return pts, ok


def recover_pose_two_view(
    uv1: torch.Tensor,       # [..., K, 2] pixels in frame 1
    uv2: torch.Tensor,       # [..., K, 2] pixels in frame 2 (matched order)
    valid: torch.Tensor,     # [..., K] bool
    intr: torch.Tensor,      # [4]
    max_repr_error: float = 4.0,
    min_tri_angle: float = 3.0 * math.pi / 180.0,
    ransac_px: float = 4.0,
    h_over_e_ratio: float = 0.9,
    min_h_points: int = 20,
    n_hyp_e: int = 512,
    n_hyp_h: int = 256,
    generator: torch.Generator | None = None,
    sample_idx_e: torch.Tensor | None = None,   # [..., n_hyp_e, 8]
    sample_idx_h: torch.Tensor | None = None,   # [..., n_hyp_h, 4]
) -> TwoViewResult:
    xy1 = pixel_to_normalized(uv1, intr)
    xy2 = pixel_to_normalized(uv2, intr)
    f_mean = 0.5 * (intr[0] + intr[1])

    res_e = estimate_essential(xy1, xy2, valid, torch.full_like(f_mean, ransac_px) / f_mean,
                               n_hyp=n_hyp_e, generator=generator,
                               sample_idx=sample_idx_e)
    res_h = estimate_homography(uv1, uv2, valid, ransac_px, n_hyp=n_hyp_h,
                                generator=generator, sample_idx=sample_idx_h)

    # --- E path ---
    T_e, _, _ = recover_pose(res_e.model, xy1, xy2, res_e.inliers)
    pts_e, ok_e = triangulate_filter(T_e, xy1, xy2, uv1, uv2, valid, intr,
                                     max_repr_error, min_tri_angle)

    # --- H path: best of the 8 calibrated decompositions ---
    Rs, ts, _, cand_valid = decompose_homography(res_h.model, intr)
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)
    Ts = rt_to_mat(Rs, ts)                                        # [..., 8, 4, 4]
    ex = lambda a: a[..., None, :, :]                             # noqa: E731
    pts_c, ok_c = triangulate_filter(Ts, ex(xy1), ex(xy2), ex(uv1), ex(uv2),
                                     valid[..., None, :], intr,
                                     max_repr_error, min_tri_angle)
    counts = torch.where(cand_valid, ok_c.sum(-1), -1)            # [..., 8]
    # torch.argmax returns the FIRST maximum on ties, as jnp.argmax does
    best = torch.argmax(counts, dim=-1)
    count_best = take_along(counts, best)
    h_ok = count_best > min_h_points

    # The H path needs H to beat E by the reference's ratio (cpp:87), to
    # explain nearly every match (a 3-D cloud leaves a depth-spread tail H
    # cannot absorb), and to triangulate at least as many gated points as
    # E (ties go to H: on a noise-free plane only H is well posed).
    n_h = res_h.n_inliers.float()
    n_valid = valid.sum(-1).float()
    use_h = ((n_h > h_over_e_ratio * res_e.n_inliers.float()) & h_ok
             & (n_h > 0.85 * n_valid) & (count_best >= ok_e.sum(-1)))

    T = torch.where(use_h[..., None, None], take_along(Ts, best), T_e)
    pts = torch.where(use_h[..., None, None], take_along(pts_c, best), pts_e)
    ok = torch.where(use_h[..., None], take_along(ok_c, best), ok_e)
    return TwoViewResult(T=T, points=pts, point_ok=ok, n_good=ok.sum(-1),
                         used_homography=use_h)


def two_view_bidirectional(uv1, uv2, valid, intr, max_repr_error=4.0,
                           min_tri_angle=3.0 * math.pi / 180.0,
                           n_hyp_e: int = 512, n_hyp_h: int = 256,
                           generator: torch.Generator | None = None):
    """Two-view recovery in both directions; returns the forward result and
    both good-counts."""
    fwd = recover_pose_two_view(uv1, uv2, valid, intr, max_repr_error,
                                min_tri_angle, n_hyp_e=n_hyp_e, n_hyp_h=n_hyp_h,
                                generator=generator)
    bwd = recover_pose_two_view(uv2, uv1, valid, intr, max_repr_error,
                                min_tri_angle, n_hyp_e=n_hyp_e, n_hyp_h=n_hyp_h,
                                generator=generator)
    return fwd, fwd.n_good, bwd.n_good


def find_best_pair(
    generator: torch.Generator | None,
    scene,
    pair_order: np.ndarray,        # host: candidate pair rows, best-first
    min_initial_inliers: int,
    max_repr_error: float,
    min_tri_angle: float,
    chunk: int = 4,
    n_hyp_e: int = 512,
    n_hyp_h: int = 256,
):
    """Scan candidate pairs ``chunk`` at a time; return the first
    acceptable ``(pair_row, TwoViewResult)`` or ``(None, None)``. The gate
    is ``n_good > min_initial_inliers`` in BOTH directions."""
    n = len(pair_order)
    for start in range(0, n, chunk):
        rows = np.asarray(pair_order[start:start + chunk])
        if len(rows) < chunk:
            rows = np.concatenate([rows, np.repeat(rows[-1:], chunk - len(rows))])
        r = torch.as_tensor(rows, dtype=torch.long, device=scene.keypoints.device)
        pi = scene.pair_idx[r].long()
        uv1 = scene.keypoints[pi[:, 0]]
        uv2 = torch.gather(scene.keypoints[pi[:, 1]], 1,
                           scene.match_ij[r].long()[..., None].expand(-1, -1, 2))
        fwd, n_f, n_b = two_view_bidirectional(
            uv1, uv2, scene.valid_ij[r], scene.intr, max_repr_error,
            min_tri_angle, n_hyp_e=n_hyp_e, n_hyp_h=n_hyp_h, generator=generator)
        n_f = n_f.cpu().numpy()
        n_b = n_b.cpu().numpy()
        for c in range(min(chunk, n - start)):
            if n_f[c] > min_initial_inliers and n_b[c] > min_initial_inliers:
                return int(rows[c]), TwoViewResult(*(a[c] for a in fwd))
    return None, None
