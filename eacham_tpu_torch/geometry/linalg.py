"""Factorization-free small-matrix helpers for batched RANSAC solving
(port of eacham_tpu/geometry/linalg.py, kept as written: the per-hypothesis
null vector is inverse iteration with CG, matvecs only; the winner's exact
refit uses ``torch.linalg`` once per estimate)."""

from __future__ import annotations

import torch

_EPS = 1e-12


def smallest_eigvec(A: torch.Tensor, outer: int = 3, cg_iters: int = 12) -> torch.Tensor:
    """Approximate unit eigenvector of the smallest eigenvalue of symmetric
    PSD ``A`` [..., n, n] -> [..., n]: inverse iteration, each solve of
    (A/tr(A) + 1e-6 I) x = v by ``cg_iters`` CG steps."""
    n = A.shape[-1]
    tr = A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = A / torch.clamp(tr, min=_EPS)
    M = M + 1e-6 * torch.eye(n, dtype=A.dtype, device=A.device)

    def cg_solve(b):
        x = torch.zeros_like(b)
        r = b
        p = r
        rz = torch.sum(r * r, dim=-1, keepdim=True)
        for _ in range(cg_iters):
            Ap = torch.einsum("...ij,...j->...i", M, p)
            denom = torch.sum(p * Ap, dim=-1, keepdim=True)
            alpha = rz / torch.clamp(denom, min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            rz2 = torch.sum(r * r, dim=-1, keepdim=True)
            p = r + (rz2 / torch.clamp(rz, min=1e-30)) * p
            rz = rz2
        return x

    v = torch.ones(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    v[..., 0] += 0.5
    v[..., n - 1] += -0.25
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(outer):
        v = cg_solve(v)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)
    return v


def inv3x3(M: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2)
    return adj / det[..., None, None]


def orthonormalize_rotation(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Nearest rotation to ``M`` [..., 3, 3] by Newton-Schulz polar iteration."""
    det = torch.linalg.det(M)
    M = M * torch.sign(det)[..., None, None]
    s = torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True) / 3.0)
    R = M / torch.clamp(s, min=_EPS)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        RtR = torch.einsum("...ji,...jk->...ik", R, R)
        R = torch.einsum("...ij,...jk->...ik", R, 1.5 * eye - 0.5 * RtR)
    return R
