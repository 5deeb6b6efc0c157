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


# --------------------------------------------------------------- distortion

def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown-Conrady forward distortion of normalized coords (..., 2).

    ``dist`` = [k1, k2, p1, p2, k3], the layout the reference's camera
    interface carries (ICamera.h:30-44). Zero coefficients are the identity.
    """
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yt = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xt, yt], dim=-1)


def undistort_normalized(xy_d: torch.Tensor, dist: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Inverse of ``distort_normalized`` by a fixed number of fixed-point
    iterations (8 converge to < 1e-3 px for lens models up to GoPro-class
    distortion)."""
    x = xy_d
    for _ in range(iters):
        d = distort_normalized(x, dist) - x
        x = xy_d - d
    return x


def undistort_keypoints(uv: torch.Tensor, intr: torch.Tensor,
                        dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Ingest hook: distorted pixel keypoints -> ideal-pinhole pixels.
    Applied once after feature extraction, so the rest of the pipeline
    stays pinhole-exact."""
    xy = pixel_to_normalized(uv, intr)
    xy_u = undistort_normalized(xy, dist, iters=iters)
    u = xy_u[..., 0] * intr[..., 0] + intr[..., 2]
    v = xy_u[..., 1] * intr[..., 1] + intr[..., 3]
    return torch.stack([u, v], dim=-1)


def reprojection_error(uv: torch.Tensor, pts_cam: torch.Tensor, intr: torch.Tensor):
    """Euclidean pixel reprojection error of camera-frame points."""
    proj = project_hom(pts_cam, intr)
    d = proj - uv
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)
