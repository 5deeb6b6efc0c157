"""Multi-scale difference-of-Gaussians keypoint detector (port of
eacham_tpu/features/detector.py), batched over frames.

Fixed-size multi-octave scale space, extrema by 3x3x3 max-pool
comparisons, Hessian edge rejection, 2-D quadratic subpixel refinement and
a static top-K with masks. Octave o+1 is seeded by subsampling octave o's
sigma = 2*SIGMA0 level; per-octave detections merge into one global top-K.

The pyramid is built with separable ``F.conv2d`` blurs on every device
(cuDNN TF32 is off, see fp.py) — the JAX package's CPU form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from eacham_tpu_torch.device import as_tensor, resolve_device

SIGMA0 = 1.6
STEP = 2.0 ** (1.0 / 3.0)
N_SCALES = 6  # produces N_SCALES-1 DoG levels
N_OCTAVES = 3


def _gauss_kernel(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_blur(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W] images (zero-padded SAME)."""
    k = torch.as_tensor(taps, device=img.device)
    r = (len(taps) - 1) // 2
    x = img[:, None]
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


def build_scale_space(img: torch.Tensor):
    """[B, H, W] grayscale -> gaussians [B, S, H, W], dogs [B, S-1, H, W].

    Each level blurs the base image directly (not the incremental
    sigma-delta cascade), as the reference does.
    """
    sigmas = [SIGMA0 * (STEP ** i) for i in range(N_SCALES)]
    g = torch.stack([_sep_blur(img, _gauss_kernel(s)) for s in sigmas], dim=1)
    return g, g[:, 1:] - g[:, :-1]


def octave_stacks(img: torch.Tensor, n_octaves: int):
    """Per-octave Gaussian stacks [(B, S, H/2^o, W/2^o)], shared by the
    detector and the descriptor."""
    stacks = []
    cur = img
    for o in range(n_octaves):
        g, _ = build_scale_space(cur)
        stacks.append(g)
        if o + 1 < n_octaves:
            cur = g[:, 3, ::2, ::2]
    return stacks


def _edge_response_ok(dog: torch.Tensor, edge_ratio: float = 10.0):
    """SIFT principal-curvature-ratio test on DoG levels [..., H, W]
    (wrap-around neighbours, as the reference's jnp.roll)."""
    def roll(x, sy, sx):
        return torch.roll(x, shifts=(sy, sx), dims=(-2, -1))

    dxx = roll(dog, 0, -1) + roll(dog, 0, 1) - 2.0 * dog
    dyy = roll(dog, -1, 0) + roll(dog, 1, 0) - 2.0 * dog
    dxy = 0.25 * (roll(dog, -1, -1) - roll(dog, -1, 1)
                  - roll(dog, 1, -1) + roll(dog, 1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    return (det > 0) & (tr * tr * r < det * (r + 1.0) ** 2)


def top_k_stable(score: torch.Tensor, k: int):
    """Top-k along the last axis with ties to the LOWER index, as
    ``lax.top_k`` does (``torch.topk`` promises no order among ties)."""
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _detect_in_dog(dog: torch.Tensor, max_keypoints: int,
                   contrast_threshold: float, border: int):
    """Single-octave extrema detection + subpixel refinement on [B, S, H, W].

    Returns (xy [B, K, 2] octave pixels, scale_idx [B, K], score [B, K],
    mask [B, K]).
    """
    B, S, H, W = dog.shape
    resp = torch.abs(dog)
    pooled = F.max_pool2d(resp, 3, stride=1, padding=1)     # -inf padded
    ninf = torch.full_like(pooled[:, :1], float("-inf"))
    up = torch.cat([pooled[:, 1:], ninf], 1)
    down = torch.cat([ninf, pooled[:, :-1]], 1)
    neighborhood = torch.maximum(pooled, torch.maximum(up, down))
    is_max = (resp >= neighborhood) & (resp > contrast_threshold)
    is_max = is_max & _edge_response_ok(dog)

    ys = torch.arange(H, device=dog.device)[:, None]
    xs = torch.arange(W, device=dog.device)[None, :]
    in_bounds = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    is_max = is_max & in_bounds

    score = torch.where(is_max, resp, float("-inf")).reshape(B, -1)
    top_score, flat_idx = top_k_stable(score, max_keypoints)
    mask = torch.isfinite(top_score)

    sidx = flat_idx // (H * W)
    rem = flat_idx % (H * W)
    y = rem // W
    x = rem % W

    d = dog.reshape(B, -1)

    def val(yi, xi):
        yi = torch.clamp(yi, 0, H - 1)
        xi = torch.clamp(xi, 0, W - 1)
        return torch.gather(d, 1, sidx * (H * W) + yi * W + xi)

    c = val(y, x)
    dx1 = val(y, x + 1)
    dx0 = val(y, x - 1)
    dy1 = val(y + 1, x)
    dy0 = val(y - 1, x)
    dpp = val(y + 1, x + 1)
    dpm = val(y + 1, x - 1)
    dmp = val(y - 1, x + 1)
    dmm = val(y - 1, x - 1)

    gx = 0.5 * (dx1 - dx0)
    gy = 0.5 * (dy1 - dy0)
    hxx = dx1 + dx0 - 2 * c
    hyy = dy1 + dy0 - 2 * c
    hxy = 0.25 * (dpp - dpm - dmp + dmm)
    det = hxx * hyy - hxy * hxy
    det_safe = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    offx = -(hyy * gx - hxy * gy) / det_safe
    offy = -(hxx * gy - hxy * gx) / det_safe
    ok_off = (torch.abs(det) > 1e-12) & (torch.abs(offx) < 1.0) & (torch.abs(offy) < 1.0)
    offx = torch.clamp(torch.where(ok_off, offx, 0.0), -0.5, 0.5)
    offy = torch.clamp(torch.where(ok_off, offy, 0.0), -0.5, 0.5)

    xy = torch.stack([x.float() + offx, y.float() + offy], dim=-1)
    xy = torch.where(mask[..., None], xy, 0.0)
    return xy, sidx, torch.where(mask, top_score, 0.0), mask


def detect_from_stacks(stacks, max_keypoints: int = 1024,
                       contrast_threshold: float = 0.006, border: int = 16):
    """Detection from per-octave Gaussian stacks [(B, S, H_o, W_o)].

    Returns ``(xy [B, K, 2] full-resolution pixels, scale_idx [B, K] —
    octave * (N_SCALES-1) + level, score [B, K], mask [B, K] bool)``.
    """
    per_oct = []
    for o, g in enumerate(stacks):
        dog = g[:, 1:] - g[:, :-1]
        b = max(border >> o, 4)
        xy, sidx, score, mask = _detect_in_dog(dog, max_keypoints,
                                               contrast_threshold, b)
        per_oct.append((xy * float(2 ** o), sidx + o * (N_SCALES - 1),
                        torch.where(mask, score, float("-inf")), mask))

    xy = torch.cat([p[0] for p in per_oct], 1)
    sidx = torch.cat([p[1] for p in per_oct], 1)
    score = torch.cat([p[2] for p in per_oct], 1)
    top, pick = top_k_stable(score, max_keypoints)
    mask = torch.isfinite(top)
    xy = torch.gather(xy, 1, pick[..., None].expand(-1, -1, 2))
    return (
        torch.where(mask[..., None], xy, 0.0),
        torch.gather(sidx, 1, pick).int(),
        torch.where(mask, top, 0.0),
        mask,
    )



@torch.no_grad()
def detect_keypoints(
    img,                           # [H, W] float32 grayscale in [0, 1]
    max_keypoints: int = 1024,
    contrast_threshold: float = 0.006,
    border: int = 16,
    n_octaves: int = N_OCTAVES,
    device: str | torch.device | None = "cuda",
):
    """Detect up to ``max_keypoints`` DoG extrema across octaves in one image.

    Returns ``(xy [K, 2] full-resolution pixels, scale_idx [K] int32 —
    octave * (N_SCALES-1) + level, score [K], mask [K] bool)``: the rows of
    ``detect_from_stacks`` on a batch of one.
    """
    img = as_tensor(img, resolve_device(device), torch.float32)
    out = detect_from_stacks(octave_stacks(img[None], n_octaves), max_keypoints,
                             contrast_threshold, border)
    return tuple(o[0] for o in out)
