"""256-d gradient-histogram descriptor (port of
eacham_tpu/features/descriptor.py), batched over frames.

A 4x4 spatial grid of 16-bin orientation histograms at the keypoint's
detected scale, Gaussian-weighted, L2-normalized with the 0.2
clip-renormalize. Dense form: per level, soft-bin gradients into BINS
orientation maps, blur them with one grouped separable convolution, then
read each descriptor as BINS-wide bilinear samples at the 16 cell centers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.features.detector import (
    N_OCTAVES, N_SCALES, SIGMA0, STEP, _gauss_kernel, octave_stacks,
)

GRID = 4          # spatial cells per side
BINS = 16         # orientation bins
DESC_DIM = GRID * GRID * BINS  # 256


def _cell_size(s: int) -> float:
    """Cell side in pixels at level s."""
    return 3.0 * SIGMA0 * (STEP ** (s + 0.5))


_CELL_POS = np.arange(GRID, dtype=np.float32) - (GRID - 1) / 2.0   # [-1.5..1.5]
_CELL_R2 = (_CELL_POS[None, :] ** 2 + _CELL_POS[:, None] ** 2).reshape(-1)
_CELL_WINDOW = np.exp(-_CELL_R2 / (2.0 * (GRID / 2.0) ** 2)).astype(np.float32)


def _level_blur_multi(hist: torch.Tensor) -> torch.Tensor:
    """Blur [B, S, BINS, H, W] with each level's own separable Gaussian in
    one grouped conv pair; shorter levels' taps are zero-padded to the
    longest radius (identical to a smaller zero-padded SAME conv)."""
    B, S, C, H, W = hist.shape
    taps = [_gauss_kernel(0.5 * _cell_size(s)) for s in range(S)]
    r = max((len(t) - 1) // 2 for t in taps)
    T = 2 * r + 1
    padded = np.zeros((S, T), np.float32)
    for s, t in enumerate(taps):
        rs = (len(t) - 1) // 2
        padded[s, r - rs:r + rs + 1] = t
    k = torch.as_tensor(np.repeat(padded, C, axis=0), device=hist.device)
    x = hist.reshape(B, S * C, H, W)
    x = F.conv2d(x, k.view(S * C, 1, T, 1), padding=(r, 0), groups=S * C)
    x = F.conv2d(x, k.view(S * C, 1, 1, T), padding=(0, r), groups=S * C)
    return x.reshape(B, S, C, H, W)


def _bilinear(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample field [B, S, C, H, W] at points x, y [B, S, M] -> [B, S, M, C]."""
    B, S, C, H, W = field.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()
    f = field.permute(0, 1, 3, 4, 2).reshape(B, S, H * W, C)

    def at(yi, xi):
        idx = (yi * W + xi)[..., None].expand(-1, -1, -1, C)
        return torch.gather(f, 2, idx)

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def describe_from_stacks(
    stacks,                  # octave_stacks(img, n_octaves): [(B, S, H, W)]
    xy: torch.Tensor,        # [B, K, 2] full-resolution pixels
    scale_idx: torch.Tensor,  # [B, K] int
    mask: torch.Tensor,      # [B, K] bool
):
    """L2-normalized descriptors [B, K, 256] (zeros where mask=False)."""
    B, K = xy.shape[:2]
    S = N_SCALES - 1
    dev = xy.device
    cells = torch.as_tensor(
        np.array([_cell_size(s) for s in range(S)], np.float32), device=dev)
    # cell-center offsets, cy-major to match _CELL_WINDOW's layout
    cxs = torch.as_tensor(np.tile(_CELL_POS, GRID), device=dev)      # [16]
    cys = torch.as_tensor(np.repeat(_CELL_POS, GRID), device=dev)
    bins = torch.arange(BINS, device=dev)[None, None, :, None, None]

    level_desc = []                                  # [B, S, K, 16, BINS] per octave
    for o, g in enumerate(stacks):
        factor = float(2 ** o)
        lvls = g[:, :S]                              # DoG levels only
        gx = 0.5 * (torch.roll(lvls, -1, dims=3) - torch.roll(lvls, 1, dims=3))
        gy = 0.5 * (torch.roll(lvls, -1, dims=2) - torch.roll(lvls, 1, dims=2))
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        ori = torch.atan2(gy, gx)

        b = (ori / (2.0 * np.pi) + 0.5) * BINS
        b0 = torch.floor(b)
        w1 = b - b0
        b0i = torch.remainder(b0.int(), BINS)        # floor-mod, as jnp's %
        b1i = torch.remainder(b0i + 1, BINS)
        hist = (mag[:, :, None] * (1.0 - w1)[:, :, None] * (b0i[:, :, None] == bins)
                + mag[:, :, None] * w1[:, :, None] * (b1i[:, :, None] == bins))
        hist = _level_blur_multi(hist)

        # all 16 cell centers x S levels in octave coords: [B, S, 16, K]
        px = (xy[:, None, None, :, 0] / factor
              + cxs[None, None, :, None] * cells[None, :, None, None])
        py = (xy[:, None, None, :, 1] / factor
              + cys[None, None, :, None] * cells[None, :, None, None])
        samp = _bilinear(hist, px.reshape(B, S, -1), py.reshape(B, S, -1))
        level_desc.append(
            samp.reshape(B, S, GRID * GRID, K, BINS).permute(0, 1, 3, 2, 4))

    all_levels = torch.cat(level_desc, dim=1)        # [B, L, K, 16, BINS]
    idx = torch.clamp(scale_idx.long(), 0, all_levels.shape[1] - 1)
    desc = torch.gather(
        all_levels, 1,
        idx[:, None, :, None, None].expand(-1, 1, -1, GRID * GRID, BINS))[:, 0]
    desc = desc * torch.as_tensor(_CELL_WINDOW, device=dev)[None, None, :, None]

    desc = desc.reshape(B, K, DESC_DIM)
    # normalize -> clip 0.2 -> renormalize (SIFT illumination guard)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
    return torch.where(mask[..., None], desc, 0.0)



@torch.no_grad()
def describe_keypoints(
    img,                     # [H, W] grayscale
    xy,                      # [K, 2] full-resolution pixels
    scale_idx,               # [K] int octave * (N_SCALES-1) + level
    mask,                    # [K] bool
    n_octaves: int = N_OCTAVES,
    device: str | torch.device | None = "cuda",
):
    """L2-normalized descriptors [K, 256] (zeros where mask=False) of one
    image's keypoints, sampled in each keypoint's own octave:
    ``describe_from_stacks`` on a batch of one."""
    dev = resolve_device(device)
    img = as_tensor(img, dev, torch.float32)
    return describe_from_stacks(
        octave_stacks(img[None], n_octaves), as_tensor(xy, dev, torch.float32)[None],
        as_tensor(scale_idx, dev)[None], as_tensor(mask, dev, torch.bool)[None])[0]
