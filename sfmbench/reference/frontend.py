"""Plain difference-of-Gaussians keypoints and 256-d descriptors.

The detector: three octaves of six Gaussian levels (sigma 1.6 * 2^(i/3),
each level blurring its octave's base image with a zero-padded separable
kernel of radius ceil(3 sigma)); the next octave's base is level 3 taken
at every second pixel. Keypoints are the extrema of |DoG| over their 3x3x3
neighbourhood above the contrast threshold that pass the principal-
curvature test (ratio 10, wrap-around neighbours) and lie inside the
border (16 px, halved each octave, at least 4); each octave keeps its K
strongest (ties to the lower index, levels before rows before columns),
refined by a 2-D quadratic fit, and the K strongest of all octaves are
returned.

The descriptor: at the keypoint's level, gradients by central differences
(wrap-around) soft-binned into 16 orientations, each orientation map
blurred with sigma of half a cell (cell = 4.8 * 2^((s + 0.5) / 3) octave
pixels), sampled bilinearly at the 4x4 cell centres, weighted by a
Gaussian window over the cells, normalised, clipped at 0.2 and
normalised again.

``dtype`` float64 is the reference; ``tf32=True`` with float32 is the
control: every convolution's operands are rounded to TF32 (10 mantissa
bits) first, as a card does with TF32 on.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SIGMA0 = 1.6
STEP = 2.0 ** (1.0 / 3.0)
LEVELS = 6
OCTAVES = 3
GRID, BINS = 4, 16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties to even)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def gauss_taps(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


class Precision:
    def __init__(self, dtype=torch.float64, tf32: bool = False):
        self.dtype, self.tf32 = dtype, tf32

    def conv(self, x, w, **kw):
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv2d(x, w, **kw)

    def taps(self, sigma, device):
        # the program keeps its taps in float32; the reference rounds them
        # the same way so that both blur with the same kernel
        return torch.as_tensor(gauss_taps(sigma).astype(np.float32), device=device).to(self.dtype)


def blur(img, sigma, pr: Precision):
    """[B, H, W] -> [B, H, W], separable, zero padded."""
    k = pr.taps(sigma, img.device)
    r = (k.numel() - 1) // 2
    x = pr.conv(img[:, None], k.view(1, 1, -1, 1), padding=(r, 0))
    x = pr.conv(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x[:, 0]


def pyramid(img, pr: Precision):
    """Per-octave Gaussian stacks [B, LEVELS, H_o, W_o]."""
    out, cur = [], img
    for o in range(OCTAVES):
        g = torch.stack([blur(cur, SIGMA0 * STEP ** i, pr) for i in range(LEVELS)], 1)
        out.append(g)
        cur = g[:, 3, ::2, ::2]
    return out


def stable_top(score, k):
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def detect_octave(dog, k, thr, border):
    B, S, H, W = dog.shape
    resp = dog.abs()
    pooled = F.max_pool2d(resp, 3, stride=1, padding=1)
    ninf = torch.full_like(pooled[:, :1], -math.inf)
    nb = torch.maximum(pooled, torch.maximum(torch.cat([pooled[:, 1:], ninf], 1),
                                             torch.cat([ninf, pooled[:, :-1]], 1)))

    def sh(x, dy, dx):
        return torch.roll(x, shifts=(dy, dx), dims=(-2, -1))

    dxx = sh(dog, 0, -1) + sh(dog, 0, 1) - 2 * dog
    dyy = sh(dog, -1, 0) + sh(dog, 1, 0) - 2 * dog
    dxy = 0.25 * (sh(dog, -1, -1) - sh(dog, -1, 1) - sh(dog, 1, -1) + sh(dog, 1, 1))
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    ok = (resp >= nb) & (resp > thr) & (det > 0) & (tr * tr * 10.0 < det * 121.0)
    ys = torch.arange(H, device=dog.device)[:, None]
    xs = torch.arange(W, device=dog.device)[None, :]
    ok = ok & (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    score, flat = stable_top(torch.where(ok, resp, -math.inf).reshape(B, -1), k)
    live = torch.isfinite(score)
    s, rem = flat // (H * W), flat % (H * W)
    y, x = rem // W, rem % W
    d = dog.reshape(B, -1)

    def at(dy, dx):
        yy = (y + dy).clamp(0, H - 1)
        xx = (x + dx).clamp(0, W - 1)
        return torch.gather(d, 1, s * H * W + yy * W + xx)

    c = at(0, 0)
    gx, gy = 0.5 * (at(0, 1) - at(0, -1)), 0.5 * (at(1, 0) - at(-1, 0))
    hxx, hyy = at(0, 1) + at(0, -1) - 2 * c, at(1, 0) + at(-1, 0) - 2 * c
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    good = det.abs() > 1e-12
    safe = torch.where(good, det, torch.ones_like(det))
    ox = -(hyy * gx - hxy * gy) / safe
    oy = -(hxx * gy - hxy * gx) / safe
    good = good & (ox.abs() < 1) & (oy.abs() < 1)
    ox = torch.where(good, ox, 0.0).clamp(-0.5, 0.5)
    oy = torch.where(good, oy, 0.0).clamp(-0.5, 0.5)
    xy = torch.stack([x.to(dog.dtype) + ox, y.to(dog.dtype) + oy], -1)
    return torch.where(live[..., None], xy, 0.0), s, torch.where(live, score, -math.inf)


def detect(stacks, k, thr, border=16):
    xys, levels, scores = [], [], []
    for o, g in enumerate(stacks):
        xy, s, sc = detect_octave(g[:, 1:] - g[:, :-1], k, thr, max(border >> o, 4))
        xys.append(xy * 2.0 ** o)
        levels.append(s + o * (LEVELS - 1))
        scores.append(sc)
    score, pick = stable_top(torch.cat(scores, 1), k)
    live = torch.isfinite(score)
    xy = torch.gather(torch.cat(xys, 1), 1, pick[..., None].expand(-1, -1, 2))
    lev = torch.gather(torch.cat(levels, 1), 1, pick)
    return torch.where(live[..., None], xy, 0.0), lev, live


def cell_size(s):
    return 3.0 * SIGMA0 * STEP ** (s + 0.5)


def describe(stacks, xy, lev, live, pr: Precision):
    B, K = xy.shape[:2]
    S = LEVELS - 1
    dev, dt = xy.device, xy.dtype
    pos = torch.arange(GRID, dtype=dt, device=dev) - (GRID - 1) / 2.0
    cx, cy = pos.repeat(GRID), pos.repeat_interleave(GRID)     # row-major cells
    window = torch.exp(-(cx ** 2 + cy ** 2) / (2.0 * (GRID / 2.0) ** 2))
    window = window.to(torch.float32).to(dt)
    per_level = []
    for o, g in enumerate(stacks):
        lv = g[:, :S]
        gx = 0.5 * (torch.roll(lv, -1, 3) - torch.roll(lv, 1, 3))
        gy = 0.5 * (torch.roll(lv, -1, 2) - torch.roll(lv, 1, 2))
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        b = (torch.atan2(gy, gx) / (2 * math.pi) + 0.5) * BINS
        b0 = torch.floor(b)
        w1 = b - b0
        i0 = torch.remainder(b0.long(), BINS)
        i1 = torch.remainder(i0 + 1, BINS)
        hist = (F.one_hot(i0, BINS) * (mag * (1 - w1))[..., None]
                + F.one_hot(i1, BINS) * (mag * w1)[..., None])      # [B, S, H, W, BINS]
        hist = hist.permute(0, 1, 4, 2, 3)
        H, W = hist.shape[-2:]
        blurred = []
        for s in range(S):
            k = pr.taps(0.5 * cell_size(s), dev)
            r = (k.numel() - 1) // 2
            x = hist[:, s].reshape(B * BINS, 1, H, W)
            x = pr.conv(x, k.view(1, 1, -1, 1), padding=(r, 0))
            x = pr.conv(x, k.view(1, 1, 1, -1), padding=(0, r))
            blurred.append(x.reshape(B, BINS, H, W))
        hist = torch.stack(blurred, 1)                                # [B, S, BINS, H, W]
        f = 2.0 ** o
        cells = torch.tensor([cell_size(s) for s in range(S)], dtype=torch.float32,
                             device=dev).to(dt)
        px = xy[:, None, None, :, 0] / f + cx[None, None, :, None] * cells[None, :, None, None]
        py = xy[:, None, None, :, 1] / f + cy[None, None, :, None] * cells[None, :, None, None]
        per_level.append(bilinear(hist, px.reshape(B, S, -1), py.reshape(B, S, -1))
                         .reshape(B, S, GRID * GRID, K, BINS).permute(0, 1, 3, 2, 4))
    allv = torch.cat(per_level, 1)                                   # [B, L, K, 16, BINS]
    idx = lev.clamp(0, allv.shape[1] - 1)
    d = torch.gather(allv, 1, idx[:, None, :, None, None].expand(-1, 1, -1, GRID * GRID, BINS))[:, 0]
    d = (d * window[None, None, :, None]).reshape(B, K, GRID * GRID * BINS)
    d = d / (d.norm(dim=-1, keepdim=True) + 1e-8)
    d = d.clamp(max=0.2)
    d = d / (d.norm(dim=-1, keepdim=True) + 1e-8)
    return torch.where(live[..., None], d, 0.0)


def bilinear(field, x, y):
    """field [B, S, C, H, W] at x, y [B, S, M] -> [B, S, M, C] (clamped)."""
    B, S, C, H, W = field.shape
    x = x.clamp(0.0, W - 1.001)
    y = y.clamp(0.0, H - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = field.permute(0, 1, 3, 4, 2).reshape(B, S, H * W, C)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * W + xx)[..., None].expand(-1, -1, -1, C))

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


@torch.no_grad()
def extract(images, max_keypoints: int, contrast_threshold: float,
            dtype=torch.float64, tf32: bool = False):
    """images [B, H, W] (any device) -> (xy [B, K, 2], desc [B, K, 256],
    live [B, K]) in ``dtype``."""
    pr = Precision(dtype, tf32)
    img = images.to(dtype)
    stacks = pyramid(img, pr)
    xy, lev, live = detect(stacks, max_keypoints, contrast_threshold)
    return xy, describe(stacks, xy, lev, live, pr), live
