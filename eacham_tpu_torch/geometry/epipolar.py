"""Essential-matrix estimation and pose recovery (port of
eacham_tpu/geometry/epipolar.py).

Hypotheses are normalized 8-point solves (inverse-iteration null vector),
scored by Sampson distance MSAC; the winner is refit once exactly
(``torch.linalg.eigh`` + ``svd``). Leading axes of the data are batch axes.

The refit makes the host wait for the card four times: ``eigh`` and ``svd``
read their error status back (``svd`` twice, on torch 2.11 with CUDA 12.8)
and the projection's diagonal is uploaded from pageable memory. Each is
counted as ``readbacks`` on the innermost span (``utils.timer``).
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.geometry.linalg import smallest_eigvec
from eacham_tpu_torch.geometry.ransac import (
    RansacResult, ransac, take_along, take_rows,
)
from eacham_tpu_torch.geometry.se3 import rt_to_mat
from eacham_tpu_torch.geometry.triangulation import triangulate_dlt
from eacham_tpu_torch.utils import timer

_EPS = 1e-12
_SQRT2 = 1.4142135623730951


def _nullvec_3x3(A: torch.Tensor, exact: bool, weights=None) -> torch.Tensor:
    """Smallest right-singular vector of A [..., rows, 9] -> [..., 3, 3]."""
    if weights is not None:
        A = A * weights[..., None]
    if exact:
        # the one refit per estimate runs in fp64: torch's fp32 eigh of this
        # 9x9 moved E by ~1e-4 from the fp64 answer, the reference's by ~2e-5
        A64 = A.double()
        AtA = A64.transpose(-1, -2) @ A64
        v = timer.readback(torch.linalg.eigh, AtA).eigenvectors[..., :, 0].to(A.dtype)
    else:
        v = smallest_eigvec(A.transpose(-1, -2) @ A)
    return v.reshape(v.shape[:-1] + (3, 3))


def _norm_pts(xy: torch.Tensor):
    """Hartley isotropic normalization of [..., M, 2] -> (pts, T [..., 3, 3])."""
    c = torch.mean(xy, dim=-2)
    d = torch.mean(torch.linalg.vector_norm(xy - c[..., None, :], dim=-1),
                   dim=-1) + _EPS
    # tensor / tensor: a python scalar over a tensor is reciprocal-times
    # in torch, which rounds differently from the reference's division
    s = torch.full_like(d, _SQRT2) / d
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -c[..., 0] * s], -1),
        torch.stack([z, s, -c[..., 1] * s], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return (xy - c[..., None, :]) * s[..., None, None], T


def eight_point(xy1: torch.Tensor, xy2: torch.Tensor, exact: bool = False,
                weights=None) -> torch.Tensor:
    """Normalized 8-point algorithm on [..., M, 2] normalized camera coords.

    exact=True projects onto the essential manifold (singular values
    (1, 1, 0)); the fast path returns the raw unit-norm model.
    """
    p1, T1 = _norm_pts(xy1)
    p2, T2 = _norm_pts(xy2)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)
    F = _nullvec_3x3(A, exact, weights)
    F = T2.transpose(-1, -2) @ F @ T1
    if not exact:
        return F / (torch.linalg.matrix_norm(F)[..., None, None] + _EPS)
    timer.add("readbacks", 2)
    U, _, Vh = torch.linalg.svd(F)
    diag = timer.readback(torch.tensor, [1.0, 1.0, 0.0], dtype=F.dtype, device=F.device)
    return (U * diag) @ Vh


def sampson_distance(E: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor):
    """First-order geometric distance to the epipolar constraint.

    E [..., 3, 3] against points [..., N, 2] -> [..., N] (broadcasting)."""
    ones = torch.ones(xy1.shape[:-1] + (1,), dtype=xy1.dtype, device=xy1.device)
    p1 = torch.cat([xy1, ones], dim=-1)
    p2 = torch.cat([xy2, ones], dim=-1)
    Ep1 = p1 @ E.transpose(-1, -2)
    Etp2 = p2 @ E
    num = torch.sum(p2 * Ep1, dim=-1)
    den = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return torch.abs(num) / torch.sqrt(den + _EPS)


def estimate_essential(
    xy1: torch.Tensor,        # [..., N, 2] normalized camera coords, frame 1
    xy2: torch.Tensor,        # [..., N, 2] normalized camera coords, frame 2
    mask: torch.Tensor,       # [..., N] bool
    threshold: float,         # Sampson threshold in normalized units
    n_hyp: int = 512,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,   # [..., n_hyp, 8]
) -> RansacResult:
    def solver(idx):
        return eight_point(take_rows(xy1, idx), take_rows(xy2, idx))

    def residual(E):
        return sampson_distance(E, xy1[..., None, :, :], xy2[..., None, :, :])

    res = ransac(mask, solver, residual, threshold, n_hyp, 8,
                 generator=generator, sample_idx=sample_idx)
    # exact refit of the winner on its inlier set, kept only if it did not
    # lose inliers (degenerate sets)
    E = eight_point(xy1, xy2, exact=True, weights=res.inliers.to(xy1.dtype))
    err = sampson_distance(E, xy1, xy2)
    inl = (err * err < threshold * threshold) & mask
    n_inl = inl.sum(-1)
    better = n_inl >= res.n_inliers
    return RansacResult(
        model=torch.where(better[..., None, None], E, res.model),
        inliers=torch.where(better[..., None], inl, res.inliers),
        n_inliers=torch.where(better, n_inl, res.n_inliers),
        score=res.score,
    )


def decompose_essential(E: torch.Tensor):
    """E -> two rotations and a unit translation (U W V^T factorization).

    ``torch.linalg.svd`` here is no kernel of this repository's: the
    reference left the SVD to XLA, outside Pallas, too."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return R1, R2, t


def recover_pose(
    E: torch.Tensor,          # [..., 3, 3]
    xy1: torch.Tensor,        # [..., N, 2]
    xy2: torch.Tensor,
    mask: torch.Tensor,       # [..., N]
    max_depth: float = 50.0,
):
    """Pick the (R, t) candidate with the most points in front of both views
    and nearer than ``max_depth`` (cv::recoverPose with distanceThresh=50).

    Returns (T [..., 4, 4] of view 2 w.r.t. view 1, n_good [...],
    good_mask [..., N]).
    """
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)               # [..., 4, 3, 3]
    ts = torch.stack([t, -t, t, -t], dim=-2)                 # [..., 4, 3]
    Ts = rt_to_mat(Rs, ts)                                   # [..., 4, 4, 4]
    eye = torch.eye(4, dtype=E.dtype, device=E.device)
    pts = triangulate_dlt(eye, Ts[..., None, :, :],
                          xy1[..., None, :, :], xy2[..., None, :, :])  # [..., 4, N, 3]
    z1 = pts[..., 2]
    pc2 = pts @ Rs.transpose(-1, -2) + ts[..., None, :]
    z2 = pc2[..., 2]
    good = ((z1 > 0) & (z2 > 0) & (z1 < max_depth) & (z2 < max_depth)
            & mask[..., None, :])
    counts = good.sum(-1)                                    # [..., 4]
    # torch.argmax returns the FIRST maximum on ties, as jnp.argmax does
    best = torch.argmax(counts, dim=-1)
    return take_along(Ts, best), take_along(counts, best), take_along(good, best)
