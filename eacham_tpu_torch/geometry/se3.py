"""Batched SE(3) operations (port of eacham_tpu/geometry/se3.py).

A frame's pose is the world->camera rigid transform T (4x4),
``x_cam = T @ x_world``. Every function works on the last one or two axes
and broadcasts over leading batch axes.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of a (..., 3) axis vector -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    rows = [
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _so3_exp(w: torch.Tensor):
    """Rodrigues formula with small-angle Taylor guards. Returns (R, V),
    V the left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W

    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))

    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, V


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3); ``xi = (..., 6)`` ordered (omega, v). Returns (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R, V = _so3_exp(w)
    t = torch.einsum("...ij,...j->...i", V, v)
    return rt_to_mat(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3), (..., 4, 4) -> (..., 6) as (omega, v)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    theta2 = theta * theta
    small = theta < 1e-4
    sin_theta = torch.sin(theta)
    k = torch.where(small, 0.5 + theta2 / 12.0, theta / (2.0 * sin_theta + 1e-30))
    Rd = R - R.transpose(-1, -2)
    w = k[..., None] * torch.stack(
        [Rd[..., 2, 1], Rd[..., 0, 2], Rd[..., 1, 0]], dim=-1)
    W = hat(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_theta / (theta + 1e-30))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + 1e-30))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b + 1e-30)) / (theta2 + 1e-30))
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(R.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4) homogeneous transform."""
    # made on the card (an uploaded constant row would wait for it)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(R.shape[:-2] + (1, 4))
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction exp(xi) @ T."""
    return exp_se3(xi) @ T


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., 3) points."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], pts) + T[..., :3, 3]


def camera_center(T: torch.Tensor) -> torch.Tensor:
    """Camera center C = -R^T t of a world->cam transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)
