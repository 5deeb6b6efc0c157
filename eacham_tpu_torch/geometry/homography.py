"""Homography estimation and decomposition (port of
eacham_tpu/geometry/homography.py).

4-point DLT hypotheses scored by forward transfer error; the SVD
(Faugeras) decomposition yields 8 (R, t, n) candidates and the caller
selects by cheirality + reprojection + triangulation angle. Leading axes
of the data are batch axes.
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.geometry.linalg import smallest_eigvec
from eacham_tpu_torch.geometry.ransac import RansacResult, ransac, take_rows

_EPS = 1e-12
_SQRT2 = 1.4142135623730951


def _nullvec(A: torch.Tensor, exact: bool, weights=None) -> torch.Tensor:
    if weights is not None:
        A = A * weights[..., None]
    if exact:
        # one refit per estimate, in fp64 as in geometry/epipolar.py
        A64 = A.double()
        AtA = A64.transpose(-1, -2) @ A64
        return torch.linalg.eigh(AtA).eigenvectors[..., :, 0].to(A.dtype)
    return smallest_eigvec(A.transpose(-1, -2) @ A)


def _norm_pts(xy: torch.Tensor):
    c = torch.mean(xy, dim=-2)
    d = torch.mean(torch.linalg.vector_norm(xy - c[..., None, :], dim=-1),
                   dim=-1) + _EPS
    s = torch.full_like(d, _SQRT2) / d
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * c[..., 0]], -1),
        torch.stack([z, s, -s * c[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return (xy - c[..., None, :]) * s[..., None, None], T


def dlt_homography(p1: torch.Tensor, p2: torch.Tensor, exact: bool = False,
                   weights=None) -> torch.Tensor:
    """DLT from [..., M>=4, 2] pixel correspondences, Hartley-normalized."""
    q1, T1 = _norm_pts(p1)
    q2, T2 = _norm_pts(p2)
    x1, y1 = q1[..., 0], q1[..., 1]
    x2, y2 = q2[..., 0], q2[..., 1]
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    rows_a = torch.stack(
        [x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rows_b = torch.stack(
        [zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    w2 = None if weights is None else torch.cat([weights, weights], dim=-1)
    H = _nullvec(A, exact, w2)
    H = H.reshape(H.shape[:-1] + (3, 3))
    H = torch.linalg.inv(T2) @ H @ T1
    h22 = H[..., 2, 2]
    h22 = torch.where(torch.abs(h22) < _EPS, torch.full_like(h22, _EPS), h22)
    return H / h22[..., None, None]


def transfer_error(H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Forward transfer error ||p2 - H p1|| in pixels (broadcasting)."""
    ones = torch.ones(p1.shape[:-1] + (1,), dtype=p1.dtype, device=p1.device)
    q = torch.cat([p1, ones], dim=-1) @ H.transpose(-1, -2)
    w = q[..., 2]
    w = torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)
    proj = q[..., :2] / w[..., None]
    return torch.linalg.vector_norm(proj - p2, dim=-1)


def estimate_homography(
    p1: torch.Tensor,     # [..., N, 2] pixels, frame 1
    p2: torch.Tensor,     # [..., N, 2] pixels, frame 2
    mask: torch.Tensor,   # [..., N] bool
    threshold: float,     # pixels
    n_hyp: int = 256,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,   # [..., n_hyp, 4]
) -> RansacResult:
    def solver(idx):
        return dlt_homography(take_rows(p1, idx), take_rows(p2, idx))

    def residual(H):
        return transfer_error(H, p1[..., None, :, :], p2[..., None, :, :])

    res = ransac(mask, solver, residual, threshold, n_hyp, 4,
                 generator=generator, sample_idx=sample_idx)
    H = dlt_homography(p1, p2, exact=True, weights=res.inliers.to(p1.dtype))
    err = transfer_error(H, p1, p2)
    inl = (err * err < threshold * threshold) & mask
    n_inl = inl.sum(-1)
    better = n_inl >= res.n_inliers
    return RansacResult(
        model=torch.where(better[..., None, None], H, res.model),
        inliers=torch.where(better[..., None], inl, res.inliers),
        n_inliers=torch.where(better, n_inl, res.n_inliers),
        score=res.score,
    )


def decompose_homography(H: torch.Tensor, intr: torch.Tensor):
    """Calibrated homography decomposition (SVD / Faugeras method).

    H [..., 3, 3], intr [4]. Returns ``R [..., 8, 3, 3], t [..., 8, 3],
    n [..., 8, 3], valid [8]``: candidates 0-3 are the d' > 0 family, 4-7
    the d' < 0 family; all eight stay valid and the caller's vote discards
    the impostors.
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                     torch.stack([z, z, o])])
    Kinv = torch.stack([torch.stack([o / fx, z, -cx / fx]),
                        torch.stack([z, o / fy, -cy / fy]),
                        torch.stack([z, z, o])])
    Hc = Kinv @ H @ K

    U, s, Vt = torch.linalg.svd(Hc)
    d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2]
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d3 = d1 / d2, d3 / d2  # now d2 == 1

    denom = torch.clamp(d1 * d1 - d3 * d3, min=_EPS)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - 1.0) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3 * d3) / denom, min=0.0))
    V = Vt.transpose(-1, -2)
    zb = torch.zeros_like(d1)
    ob = torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    def family(e1, e3, positive: bool):
        if positive:
            sin_t = (d1 - d3) * x1 * x3 * e1 * e3
            cos_t = d1 * x3 * x3 + d3 * x1 * x1
            Rp = mat([[cos_t, zb, -sin_t], [zb, ob, zb], [sin_t, zb, cos_t]])
            tp = (d1 - d3)[..., None] * torch.stack([x1 * e1, zb, -x3 * e3], -1)
        else:
            sin_p = (d1 + d3) * x1 * x3 * e1 * e3
            cos_p = d3 * x1 * x1 - d1 * x3 * x3
            Rp = mat([[cos_p, zb, sin_p], [zb, -ob, zb], [sin_p, zb, -cos_p]])
            tp = (d1 + d3)[..., None] * torch.stack([x1 * e1, zb, x3 * e3], -1)
        np_ = torch.stack([x1 * e1, zb, x3 * e3], -1)
        R = detUV[..., None, None] * (U @ Rp @ Vt)
        t = (U @ tp[..., None])[..., 0]
        n = (V @ np_[..., None])[..., 0]
        # flip so the plane faces the first camera (n_z > 0)
        sign = torch.where(n[..., 2] < 0.0, -ob, ob)[..., None]
        return R, t * sign, n * sign

    Rs, ts, ns = [], [], []
    for positive in (True, False):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                R, t, n = family(e1, e3, positive)
                Rs.append(R)
                ts.append(t)
                ns.append(n)
    valid = torch.ones(8, dtype=torch.bool, device=H.device)
    return torch.stack(Rs, -3), torch.stack(ts, -2), torch.stack(ns, -2), valid
