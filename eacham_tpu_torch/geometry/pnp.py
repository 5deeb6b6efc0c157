"""Perspective-n-Point: batched DLT hypotheses + MSAC + Gauss-Newton polish
(port of eacham_tpu/geometry/pnp.py).

A 6-point DLT hypothesis is linear (the null vector of one 12x12 normal
matrix, by the port's factorization-free ``smallest_eigvec``), exact on
noise-free samples, and after the masked Gauss-Newton polish on the inlier
set reaches the accuracy of an EPnP RANSAC. All hypotheses are solved and
scored in one pass of tensor ops.
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.geometry.camera import pixel_to_normalized, project_hom
from eacham_tpu_torch.geometry.linalg import orthonormalize_rotation, smallest_eigvec
from eacham_tpu_torch.geometry.ransac import ransac, take_rows
from eacham_tpu_torch.geometry.se3 import exp_se3, hat, rt_to_mat, transform_points

_EPS = 1e-12


def dlt_pnp(pts3d: torch.Tensor, xy: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Linear PnP from >= 6 3D <-> normalized-2D correspondences,
    ``pts3d`` [..., S, 3], ``xy`` [..., S, 2] -> T [..., 4, 4].

    Solves for the projection P = [R|t] up to scale as a 12-dim null
    vector, then projects onto SE(3). The 3D points are centered and scaled
    first (Hartley normalization), which the fp32 conditioning of the 12x12
    problem needs. ``exact`` takes the null vector and the nearest rotation
    from ``torch.linalg`` instead of the matmul-only per-hypothesis forms.
    """
    c = pts3d.mean(-2, keepdim=True)
    norm_scale = torch.linalg.vector_norm(pts3d - c, dim=-1).mean(-1) + _EPS   # [...]
    pts3d = (pts3d - c) / norm_scale[..., None, None]
    c = c[..., 0, :]

    X, Y, Z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    x, y = xy[..., 0], xy[..., 1]
    ones = torch.ones_like(X)
    zeros = torch.zeros_like(X)
    rows_a = torch.stack(
        [X, Y, Z, ones, zeros, zeros, zeros, zeros, -x * X, -x * Y, -x * Z, -x], dim=-1)
    rows_b = torch.stack(
        [zeros, zeros, zeros, zeros, X, Y, Z, ones, -y * X, -y * Y, -y * Z, -y], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    if exact:
        _, vecs = torch.linalg.eigh(AtA)
        P = vecs[..., :, 0]
    else:
        P = smallest_eigvec(AtA)
    P = P.reshape(P.shape[:-1] + (3, 4))

    # fix the sign so the sampled points sit in front of the camera
    z_mean = (torch.einsum("...sj,...j->...s", pts3d, P[..., 2, :3]) + P[..., 2, 3:4]).mean(-1)
    P = P * torch.where(z_mean < 0, -1.0, 1.0)[..., None, None]

    # project the rotation part onto SO(3); rescale t consistently
    M = P[..., :3]
    if exact:
        U, s, Vt = torch.linalg.svd(M)
        scale = s.mean(-1)
        d = torch.linalg.det(U @ Vt)
        fix = torch.ones_like(s)
        fix[..., 2] = d
        R = (U * fix[..., None, :]) @ Vt
    else:
        scale = torch.sqrt(torch.sum(M * M, dim=(-2, -1)) / 3.0)
        R = orthonormalize_rotation(M)
    t_norm = P[..., 3] / torch.where(scale < _EPS, _EPS, scale)[..., None]
    # undo the normalization: x_cam ~ R (X - c) / s + t_norm, proportional to R X + (s t_norm - R c)
    t = norm_scale[..., None] * t_norm - torch.einsum("...ij,...j->...i", R, c)
    return rt_to_mat(R, t)


def _reproj_residual_px(T, pts3d, uv, intr):
    """Pixel reprojection error of ``pts3d`` [..., N, 3] under ``T``
    [..., 4, 4] (broadcast) -> [..., N]; behind-camera points are never
    inliers."""
    pc = transform_points(T[..., None, :, :], pts3d)
    err = torch.linalg.vector_norm(project_hom(pc, intr) - uv, dim=-1)
    return torch.where(pc[..., 2] > 0, err, 1e6)


def gauss_newton_pose(T0: torch.Tensor, pts3d: torch.Tensor, uv: torch.Tensor,
                      intr: torch.Tensor, weights: torch.Tensor,
                      iters: int = 10, damping: float = 1e-6) -> torch.Tensor:
    """Masked Gauss-Newton refinement of a pose [..., 4, 4] on [..., N]
    weighted correspondences (leading axes are independent problems): a
    fixed iteration count, left-multiplicative se(3) updates, analytic
    Jacobians."""
    T = T0
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    fx, fy = intr[0], intr[1]
    w = weights[..., None, None]
    for _ in range(iters):
        pc = transform_points(T if T.dim() == 2 else T[..., None, :, :], pts3d)   # [..., N, 3]
        z = torch.clamp(pc[..., 2], min=_EPS)
        inv_z = 1.0 / z
        zeros = torch.zeros_like(z)
        du = torch.stack([fx * inv_z, zeros, -fx * pc[..., 0] * inv_z * inv_z], dim=-1)
        dv = torch.stack([zeros, fy * inv_z, -fy * pc[..., 1] * inv_z * inv_z], dim=-1)
        J_pc = torch.stack([du, dv], dim=-2)                  # [..., N, 2, 3]
        # d(pc)/d(xi) for a left perturbation: [-[pc]_x | I] (omega, v)
        dpc = torch.cat([-hat(pc), eye3.expand(pc.shape[:-1] + (3, 3))], dim=-1)   # [..., N, 3, 6]
        J = J_pc @ dpc                                        # [..., N, 2, 6]
        r = project_hom(pc, intr) - uv                        # [..., N, 2]
        JtJ = torch.einsum("...nik,...nij->...kj", J * w, J)
        Jtr = torch.einsum("...nik,...ni->...k", J * w, r)
        # solve_ex without its error check: the same LU solve as torch.linalg.solve,
        # with no read of its info back to the host
        dx = -torch.linalg.solve_ex(JtJ + damping * eye6, Jtr, check_errors=False).result
        T = exp_se3(dx) @ T
    return T


def solve_pnp_ransac(
    pts3d: torch.Tensor,      # [..., N, 3] world points
    uv: torch.Tensor,         # [..., N, 2] pixel observations
    mask: torch.Tensor,       # [..., N] bool
    intr: torch.Tensor,       # [4]
    threshold: float = 4.0,   # px
    n_hyp: int = 512,
    refine_iters: int = 10,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,   # [..., n_hyp, 6], overrides sampling
    uniforms: torch.Tensor | None = None,     # [..., n_hyp, N], drawn in advance
):
    """Returns (T [..., 4, 4] world->cam, inliers [..., N] bool, n_inliers
    [...]). Leading axes are independent problems, solved in one batched
    RANSAC (the loop-closing measurements take their edges this way).
    ``uniforms``: the sampler's draw (``ransac.draw_uniforms``) made by the
    caller, which then leaves ``generator`` untouched here."""
    xy = pixel_to_normalized(uv, intr)
    batched = mask.dim() > 1
    # hypotheses get their own axis in front of the point axis
    pts_h = pts3d[..., None, :, :] if batched else pts3d
    uv_h = uv[..., None, :, :] if batched else uv

    def solver(idx):
        return dlt_pnp(take_rows(pts3d, idx), take_rows(xy, idx))

    def residual(T):
        return _reproj_residual_px(T, pts_h, uv_h, intr)

    res = ransac(mask, solver, residual, threshold, n_hyp, 6,
                 generator=generator, sample_idx=sample_idx, uniforms=uniforms)
    # polish on the inlier set, then recompute the inlier mask once
    T = gauss_newton_pose(res.model, pts3d, uv, intr, res.inliers.to(uv.dtype),
                          iters=refine_iters)
    err = _reproj_residual_px(T, pts3d, uv, intr)
    inl = (err < threshold) & mask
    return T, inl, inl.sum(-1)
