"""Plain geometry for judging a reconstruction against its ground truth:
the similarity-aligned trajectory error, epipolar (Sampson) distances under
the true relative poses, and per-camera and per-landmark Gauss-Newton
steps that tell how far a bundle-adjusted map's poses and landmarks lie
from their optimum, all in float64.
"""

from __future__ import annotations

import numpy as np
import torch

PX_SIGMA = 1.5      # the bundle adjustment's pixel noise model (a Huber loss at
PX_HUBER = 3.0      # 3 sigma on the whitened error): the cost the map minimises


def centres(poses: np.ndarray) -> np.ndarray:
    """Camera centres of world->camera poses [M, 4, 4]."""
    p = np.asarray(poses, np.float64)
    return -np.einsum("nji,nj->ni", p[:, :3, :3], p[:, :3, 3])


def ate(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """RMSE of camera centres after the least-squares similarity (Umeyama)
    that maps the estimate onto the truth; inf with fewer than 3 poses or
    non-finite ones."""
    a, b = centres(est_poses), centres(gt_poses)
    if len(a) < 3 or not np.isfinite(a).all():
        return float("inf")
    ma, mb = a.mean(0), b.mean(0)
    xa, xb = a - ma, b - mb
    U, D, Vt = np.linalg.svd(xb.T @ xa / len(a))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / max((xa * xa).sum() / len(a), 1e-300)
    err = (s * (R @ xa.T)).T + mb - b
    return float(np.sqrt((err * err).sum(1).mean()))


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def sampson_px(uv_i, uv_j, T_i, T_j, intr) -> torch.Tensor:
    """Sampson distance (pixels, at the mean focal length) of matches
    uv_i [P, M, 2] <-> uv_j [P, M, 2] under the true world->camera poses
    T_i, T_j [P, 4, 4]."""
    fx, fy, cx, cy = (float(v) for v in intr)
    T = T_j @ torch.linalg.inv(T_i)
    E = skew(T[:, :3, 3]) @ T[:, :3, :3]
    one = torch.ones_like(uv_i[..., :1])
    x1 = torch.cat([(uv_i[..., :1] - cx) / fx, (uv_i[..., 1:] - cy) / fy, one], -1)
    x2 = torch.cat([(uv_j[..., :1] - cx) / fx, (uv_j[..., 1:] - cy) / fy, one], -1)
    Ex1 = x1 @ E.transpose(1, 2)
    Etx2 = x2 @ E
    num = (x2 * Ex1).sum(-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num.abs() / torch.sqrt(den.clamp(min=1e-300)) * 0.5 * (fx + fy)


# ---- how far a map's poses lie from their optimum ------------------------------------------

def _huber_w(rn):
    """IRLS weight of the whitened error norm (Huber at PX_HUBER)."""
    return torch.where(rn <= PX_HUBER, torch.ones_like(rn), PX_HUBER / rn.clamp(min=1e-300))


def _rho(rn):
    return torch.where(rn <= PX_HUBER, 0.5 * rn * rn, PX_HUBER * (rn - 0.5 * PX_HUBER))


def _residuals(R, t, X, intr, cam, pt, uv):
    """Whitened residuals [O, 2] and camera-frame points [O, 3]."""
    Xc = (R[cam] @ X[pt][..., None])[..., 0] + t[cam]
    z = Xc[:, 2:3]
    proj = torch.cat([intr[0] * Xc[:, :1] / z + intr[2], intr[1] * Xc[:, 1:2] / z + intr[3]], 1)
    return (proj - uv) / PX_SIGMA, Xc


def _proj_jac(Xc, intr):
    """d(whitened projection)/d(camera-frame point) [O, 2, 3]."""
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([intr[0] / z, zero, -intr[0] * x / z ** 2], -1),
                     torch.stack([zero, intr[1] / z, -intr[1] * y / z ** 2], -1)], 1)
    return J / PX_SIGMA


def _costs(r, seg, n):
    rho = _rho(r.norm(dim=1))
    return torch.zeros(n, dtype=r.dtype, device=r.device).index_add_(0, seg, rho)


def _so3_exp(w):
    th = w.norm(dim=-1, keepdim=True)[..., None]
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(K)
    small = th < 1e-12
    th_s = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, torch.ones_like(th), torch.sin(th_s) / th_s)
    B = torch.where(small, 0.5 * torch.ones_like(th), (1 - torch.cos(th_s)) / th_s ** 2)
    return eye + A * K + B * (K @ K)


def refine_poses(R, t, X, intr, cam, pt, uv, cam_free, iters: int = 3):
    """Per-camera (6x6) Gauss-Newton steps on the robust reprojection cost,
    landmarks held, each camera's step kept only where it lowers that
    camera's cost. Returns (R, t)."""
    N = R.shape[0]
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r, Xc = _residuals(R, t, X, intr, cam, pt, uv)
        w = _huber_w(r.norm(dim=1))
        Jp = _proj_jac(Xc, intr)
        J = torch.cat([Jp @ -skew(Xc), Jp], 2)                # d/d(w, v): Xc += w x Xc + v
        H = torch.zeros(N, 6, 6, dtype=X.dtype, device=X.device).index_add_(
            0, cam, w[:, None, None] * J.transpose(1, 2) @ J)
        g = torch.zeros(N, 6, dtype=X.dtype, device=X.device).index_add_(
            0, cam, w[:, None] * (J.transpose(1, 2) @ r[..., None])[..., 0])
        step = -torch.linalg.solve(H + 1e-9 * eye6, g[..., None])[..., 0]
        step = torch.where(cam_free[:, None], step, 0.0)
        dR = _so3_exp(step[:, :3])
        R2, t2 = dR @ R, (dR @ t[..., None])[..., 0] + step[:, 3:]
        before = _costs(r, cam, N)
        r2, _ = _residuals(R2, t2, X, intr, cam, pt, uv)
        keep = _costs(r2, cam, N) < before
        R = torch.where(keep[:, None, None], R2, R)
        t = torch.where(keep[:, None], t2, t)
    return R, t


POINT_FIRM = 30.0   # a landmark is judged along the directions its observations fix at
                    # least this many times more firmly than the bundle adjustment's
                    # point prior (sigma 1 / observers) does


def refine_points(R, t, X, intr, cam, pt, uv, iters: int = 3, firm: float | None = POINT_FIRM):
    """Per-landmark (3x3) Gauss-Newton steps on the robust reprojection
    cost, poses held, each landmark's step kept only where it lowers that
    landmark's cost. With ``firm`` the step is taken only along the
    eigenvectors of a landmark's normal matrix whose eigenvalue is at least
    ``firm`` times the information of the BA's point prior (observers
    squared): along the others, such as the depth of a landmark seen from
    nearby views, the program's BA holds the landmark by that prior, which
    the map does not keep. ``firm`` None steps freely. Returns X."""
    L = X.shape[0]
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    n = torch.zeros(L, dtype=X.dtype, device=X.device).index_add_(
        0, pt, torch.ones(len(pt), dtype=X.dtype, device=X.device))
    for _ in range(iters):
        r, Xc = _residuals(R, t, X, intr, cam, pt, uv)
        w = _huber_w(r.norm(dim=1))
        J = _proj_jac(Xc, intr) @ R[cam]                      # d/dX
        H = torch.zeros(L, 3, 3, dtype=X.dtype, device=X.device).index_add_(
            0, pt, w[:, None, None] * J.transpose(1, 2) @ J)
        g = torch.zeros(L, 3, dtype=X.dtype, device=X.device).index_add_(
            0, pt, w[:, None] * (J.transpose(1, 2) @ r[..., None])[..., 0])
        lam, V = torch.linalg.eigh(H + 1e-12 * eye3)
        coef = (V.transpose(1, 2) @ g[..., None])[..., 0] / lam
        if firm is not None:
            coef = torch.where(lam >= firm * n[:, None] ** 2, coef, 0.0)
        X2 = X - (V @ coef[..., None])[..., 0]
        before = _costs(r, pt, L)
        r2, _ = _residuals(R, t, X2, intr, cam, pt, uv)
        keep = _costs(r2, pt, L) < before
        X = torch.where(keep[:, None], X2, X)
    return X


def map_cost(R, t, X, intr, cam, pt, uv) -> float:
    r, _ = _residuals(R, t, X, intr, cam, pt, uv)
    return float(_rho(r.norm(dim=1)).sum())
