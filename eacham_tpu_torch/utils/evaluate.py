"""Trajectory evaluation: Umeyama similarity alignment + ATE.

The reference verifies trajectories visually in a Pangolin window
(apps/sfm/view/GraphView.h:27-74); here quality is a number. Monocular SfM
is defined up to a 7-DoF similarity, so trajectories are aligned with the
closed-form Umeyama solution before computing the RMSE of camera centers —
the standard ATE protocol (also what the BASELINE.md targets specify).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform mapping ``src`` -> ``dst``.

    src, dst: [N, 3]. Returns (s, R [3,3], t [3]) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs * xs).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def relative_pose_error_deg(T_rel: np.ndarray, T_i: np.ndarray, T_j: np.ndarray):
    """Rotation angle and translation-direction angle (degrees) between an
    estimated relative pose ``T_rel`` (frame i's camera -> frame j's
    camera) and the one of ground-truth world->cam poses ``T_i``, ``T_j``.
    Monocular two-view translation is known up to scale, so only its
    direction is compared."""
    T_rel = np.asarray(T_rel, np.float64)
    T_gt = np.asarray(T_j, np.float64) @ np.linalg.inv(np.asarray(T_i, np.float64))
    dR = T_rel[:3, :3] @ T_gt[:3, :3].T
    rot = np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    a = T_rel[:3, 3] / max(np.linalg.norm(T_rel[:3, 3]), 1e-12)
    b = T_gt[:3, 3] / max(np.linalg.norm(T_gt[:3, 3]), 1e-12)
    trans = np.degrees(np.arccos(np.clip(a @ b, -1.0, 1.0)))
    return float(rot), float(trans)


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """RMSE of camera centers after similarity alignment.

    Degenerate input (fewer than 3 poses, or non-finite centers from a
    diverged solve) returns ``inf`` instead of raising — callers gate on a
    threshold, and LAPACK's SVD does not converge on NaNs.
    """
    est_centers = np.asarray(est_centers, np.float64)
    gt_centers = np.asarray(gt_centers, np.float64)
    if (len(est_centers) < 3 or not np.isfinite(est_centers).all()
            or not np.isfinite(gt_centers).all()):
        return float("inf")
    s, R, t = align_umeyama(est_centers, gt_centers)
    aligned = (s * (R @ est_centers.T)).T + t
    err = aligned - gt_centers
    return float(np.sqrt((err * err).sum(-1).mean()))


def trajectory_ate(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """ATE RMSE between two sets of world->cam poses [M, 4, 4]: the RMSE of
    their camera centres after similarity alignment."""
    est, gt = np.asarray(est_poses, np.float64), np.asarray(gt_poses, np.float64)
    c_est = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("nij,ni->nj", gt[:, :3, :3], gt[:, :3, 3])
    return float(ate_rmse(c_est, c_gt))
