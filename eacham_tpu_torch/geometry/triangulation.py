"""Batched DLT triangulation (port of eacham_tpu/geometry/triangulation.py).

The DLT system is solved in inhomogeneous form through 3x3 normal
equations with a closed-form adjugate inverse: no eigen/SVD call at all.
All arguments broadcast over leading batch axes.
"""

from __future__ import annotations

import math

import torch

from eacham_tpu_torch.geometry.se3 import camera_center

_EPS = 1e-12


def triangulate_dlt(T1: torch.Tensor, T2: torch.Tensor,
                    xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT in normalized camera coordinates.

    ``T1, T2``: (..., 4, 4) world->cam; ``xy1, xy2``: (..., 2). Returns
    (..., 3) world points; points at infinity come back huge and are
    rejected by the callers' depth/reprojection gates.
    """
    rows = []
    for T, xy in ((T1, xy1), (T2, xy2)):
        p0 = T[..., 0, :]
        p1 = T[..., 1, :]
        p2 = T[..., 2, :]
        rows.append(xy[..., 0:1] * p2 - p0)
        rows.append(xy[..., 1:2] * p2 - p1)
    rows = torch.broadcast_tensors(*rows)
    A = torch.stack(rows, dim=-2)                     # (..., 4, 4)
    B = A[..., :3]                                    # (..., 4, 3)
    b = -A[..., 3]                                    # (..., 4)
    M = B.transpose(-1, -2) @ B                       # (..., 3, 3)
    rhs = torch.einsum("...ij,...i->...j", B, b)      # (..., 3)
    return _solve3x3(M, rhs)


def _solve3x3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form solve of symmetric 3x3 systems (adjugate / Cramer)."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(torch.abs(det) < _EPS, torch.full_like(det, _EPS), det)
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    x = torch.stack([
        c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2],
        c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2],
        c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2],
    ], dim=-1)
    return x / det[..., None]


def triangulation_angle(T1: torch.Tensor, T2: torch.Tensor,
                        point: torch.Tensor) -> torch.Tensor:
    """Angle between the two viewing rays at ``point``, folded to <= pi/2.
    Poses broadcast against the points (give a pose shared by a [..., K, 3]
    point set as [..., 1, 4, 4])."""
    c1 = camera_center(T1)
    c2 = camera_center(T2)
    r1 = point - c1
    r2 = point - c2
    n1 = torch.linalg.vector_norm(r1, dim=-1)
    n2 = torch.linalg.vector_norm(r2, dim=-1)
    cos = torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=_EPS)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    return torch.minimum(ang, math.pi - ang)


def is_positive_depth(T: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Cheirality test: point in front of the camera."""
    z = torch.einsum("...j,...j->...", T[..., 2, :3], point) + T[..., 2, 3]
    return z > 0.0
