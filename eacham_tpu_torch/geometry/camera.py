"""Pinhole camera model, batched (port of eacham_tpu/geometry/camera.py).

Intrinsics are a flat (..., 4) tensor ``[fx, fy, cx, cy]`` (zero skew).
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.geometry.se3 import transform_points


def make_intrinsics(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy], dtype=dtype, device=device)


def intrinsics_from_image_size(width: int, height: int, focal_scale: float = 1.2,
                               device=None):
    """Initial-K heuristic: f = focal_scale * max(w, h), principal point at
    the image center."""
    f = focal_scale * max(width, height)
    return make_intrinsics(f, f, 0.5 * width, 0.5 * height, device=device)


def K_matrix(intr: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) calibration matrix."""
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    rows = [
        torch.stack([fx, zeros, cx], dim=-1),
        torch.stack([zeros, fy, cy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def project_hom(pts_cam: torch.Tensor, intr: torch.Tensor, eps: float = 1e-12):
    """Camera-frame points (..., 3) -> pixels (..., 2), guarded divide."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    u = intr[..., 0] * pts_cam[..., 0] * inv_z + intr[..., 2]
    v = intr[..., 1] * pts_cam[..., 1] * inv_z + intr[..., 3]
    return torch.stack([u, v], dim=-1)


def project(T: torch.Tensor, pts_world: torch.Tensor, intr: torch.Tensor):
    """World points -> (pixels, depth) through a world->cam transform."""
    pc = transform_points(T, pts_world)
    return project_hom(pc, intr), pc[..., 2]


def backproject(uv: torch.Tensor, depth: torch.Tensor, intr: torch.Tensor):
    """Pixels + depth -> camera-frame 3D points."""
    x = (uv[..., 0] - intr[..., 2]) / intr[..., 0] * depth
    y = (uv[..., 1] - intr[..., 3]) / intr[..., 1] * depth
    return torch.stack([x, y, depth], dim=-1)


def pixel_to_normalized(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized camera coordinates (K^{-1})."""
    x = (uv[..., 0] - intr[..., 2]) / intr[..., 0]
    y = (uv[..., 1] - intr[..., 3]) / intr[..., 1]
    return torch.stack([x, y], dim=-1)


def reprojection_error(uv: torch.Tensor, pts_cam: torch.Tensor, intr: torch.Tensor):
    """Euclidean pixel reprojection error of camera-frame points."""
    proj = project_hom(pts_cam, intr)
    d = proj - uv
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)
