"""SuperPoint-class deep keypoint detector + descriptor (port of
eacham_tpu/features/deep/superpoint.py).

A shared VGG-style encoder at 1/8 resolution; a detector head producing a
65-way cell softmax (8x8 positions + dustbin) unpacked to a
full-resolution heatmap; a descriptor head producing a 256-d field sampled
bilinearly at the keypoints. Static top-K selection with masks.

Public layouts are the reference's: images [B, H, W] in [0, 1], descriptor
field [B, H/8, W/8, 256], outputs (xy [B, K, 2], desc [B, K, 256], score
[B, K], mask [B, K]). Inside the network tensors are NCHW. Module names
follow the reference's parameter tree (``backbone.c1a`` ... ``desc2``), so
``convert.superpoint_from_numpy`` carries its weights across, and
``init_params`` initialises it as flax does (``lecun_init_``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eacham_tpu_torch.features.detector import _gauss_kernel, _sep_blur, top_k_stable
from eacham_tpu_torch.utils import timer

CELL = 8
DESC_DIM = 256
SCORE_THRESHOLD = 0.05


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        chans = (("c1", 1, 64), ("c2", 64, 64), ("c3", 64, 128), ("c4", 128, 128))
        for name, cin, cout in chans:
            setattr(self, f"{name}a", nn.Conv2d(cin, cout, 3, padding=1))
            setattr(self, f"{name}b", nn.Conv2d(cout, cout, 3, padding=1))

    def forward(self, x):
        # x: [B, 1, H, W]
        for stage in ("c1", "c2", "c3", "c4"):
            x = F.relu(getattr(self, f"{stage}a")(x))
            x = F.relu(getattr(self, f"{stage}b")(x))
            if stage != "c4":
                x = F.max_pool2d(x, 2, 2)
        return x                                   # [B, 128, H/8, W/8]


class SuperPointNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = _Backbone()
        self.det1 = nn.Conv2d(128, 256, 3, padding=1)
        self.det2 = nn.Conv2d(256, CELL * CELL + 1, 1)
        self.desc1 = nn.Conv2d(128, 256, 3, padding=1)
        self.desc2 = nn.Conv2d(256, DESC_DIM, 1)

    def forward(self, images):
        """images: [B, H, W] in [0, 1] with H, W multiples of 8.

        Returns (heatmap [B, H, W], desc_field [B, H/8, W/8, 256]).
        """
        feat = self.backbone(images[:, None])

        det = self.det2(F.relu(self.det1(feat)))            # [B, 65, h, w]
        prob = torch.softmax(det, dim=1)[:, :-1]            # drop the dustbin
        B, _, h, w = prob.shape
        # channel c = cy * 8 + cx is pixel (cy, cx) of its cell, row-major
        heat = prob.reshape(B, CELL, CELL, h, w).permute(0, 3, 1, 4, 2)
        heat = heat.reshape(B, h * CELL, w * CELL)

        desc = self.desc2(F.relu(self.desc1(feat))).permute(0, 2, 3, 1)
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        return heat, desc


def _nms_heat(heat: torch.Tensor, radius: int = 4):
    """Suppress non-local-maxima within a (2r+1)^2 window (-inf padded)."""
    pooled = F.max_pool2d(heat[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]
    return torch.where(heat >= pooled, heat, 0.0)


def _bilinear_field(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample [B, h, w, C] at float coords [B, K] (in field units), clamped."""
    B, h, w, _ = field.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    b = torch.arange(B, device=field.device)[:, None]
    v00 = field[b, y0, x0]
    v01 = field[b, y0, x0 + 1]
    v10 = field[b, y0 + 1, x0]
    v11 = field[b, y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _soft_refine(heat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Per-keypoint subpixel offset in [-1, 1]^2: probability-weighted
    centroid of the 3x3 heat neighborhood. heat [B, H, W], xy [B, K, 2]."""
    B, H, W = heat.shape
    d = torch.arange(-1, 2, device=heat.device)
    x0 = xy[..., 0].long()                               # truncates, as astype
    y0 = xy[..., 1].long()
    ys = torch.clamp(y0[:, :, None, None] + d[None, None, :, None], 0, H - 1)
    xs = torch.clamp(x0[:, :, None, None] + d[None, None, None, :], 0, W - 1)
    b = torch.arange(B, device=heat.device)[:, None, None, None]
    w = heat[b, ys, xs]                                  # [B, K, 3, 3]
    wsum = torch.clamp(w.sum(dim=(2, 3)), min=1e-12)
    df = d.to(heat.dtype)
    fx = (w.sum(dim=2) * df).sum(-1) / wsum
    fy = (w.sum(dim=3) * df).sum(-1) / wsum
    return torch.stack([fx, fy], -1)


def _image_quadratic_refine(images: torch.Tensor, xy_int: torch.Tensor,
                            sigma: float = 1.0):
    """Full 2-D quadratic fit (offset = -H^{-1} g) on the sigma-blurred image
    intensity at each integer detection: localizes the photometric
    structure every view sees. images [B, H, W], xy_int [B, K, 2] integer.
    Returns (offsets [B, K, 2], ok [B, K])."""
    B, H, W = images.shape
    # the taps go from the host to the card: a wait, counted
    taps = timer.readback(torch.as_tensor, _gauss_kernel(sigma), device=images.device)
    blur = _sep_blur(images, taps)
    xi = xy_int[..., 0].long()
    yi = xy_int[..., 1].long()
    b = torch.arange(B, device=images.device)[:, None]

    def v(dy, dx):
        return blur[b, torch.clamp(yi + dy, 0, H - 1), torch.clamp(xi + dx, 0, W - 1)]

    c = v(0, 0)
    dx1, dx0 = v(0, 1), v(0, -1)
    dy1, dy0 = v(1, 0), v(-1, 0)
    dpp, dpm = v(1, 1), v(1, -1)
    dmp, dmm = v(-1, 1), v(-1, -1)
    gx = 0.5 * (dx1 - dx0)
    gy = 0.5 * (dy1 - dy0)
    hxx = dx1 + dx0 - 2 * c
    hyy = dy1 + dy0 - 2 * c
    hxy = 0.25 * (dpp - dpm - dmp + dmm)
    det = hxx * hyy - hxy * hxy
    ds = torch.where(det.abs() > 1e-12, det, 1.0)
    ox = -(hyy * gx - hxy * gy) / ds
    oy = -(hxx * gy - hxy * gx) / ds
    # refine only true photometric peaks with an in-cell solution
    ok = ((det.abs() > 1e-12) & (ox.abs() < 1.0) & (oy.abs() < 1.0)
          & (hxx < 0) & (hyy < 0))
    off = torch.stack([torch.clamp(ox, -0.6, 0.6), torch.clamp(oy, -0.6, 0.6)], -1)
    return off, ok


@torch.no_grad()
def extract_deep(
    model: SuperPointNet,
    images: torch.Tensor,     # [B, H, W] float32 in [0, 1], H, W % 8 == 0
    max_keypoints: int = 1024,
    score_threshold: float = SCORE_THRESHOLD,
    nms_radius: int = 4,
    refine: bool = True,
):
    """Deep frontend inference with the classical frontend's contract:
    returns (xy [B, K, 2], desc [B, K, 256], score [B, K], mask [B, K]) on
    the images' device (the model's parameters must live there too)."""
    heat_raw, desc_field = model(images)
    heat = _nms_heat(heat_raw, nms_radius)
    B, H, W = heat.shape

    # after NMS most of the heatmap is tied at 0: ties go to the lower index
    score, idx = top_k_stable(heat.reshape(B, -1), max_keypoints)
    yy = (idx // W).float()
    xx = (idx % W).float()
    mask = score >= score_threshold
    xy = torch.stack([xx, yy], -1)
    # Subpixel refinement, two tiers: an image-space quadratic fit at
    # photometric peaks; where that fit is invalid, a 3x3 soft-argmax on the
    # RAW heatmap (NMS zeroes the neighbours, so read pre-NMS).
    if refine:
        xy_soft = xy + _soft_refine(heat_raw, xy)
        xy_int = torch.round(xy_soft)                    # half to even
        off_img, ok_img = _image_quadratic_refine(images, xy_int)
        xy = torch.where(ok_img[..., None], xy_int + off_img, xy_soft)
    else:
        xy_soft = xy

    # descriptors are sampled at the soft-refined position: the image fit
    # moves points <= 0.6 px, far below the descriptor field's 8 px grid
    desc = _bilinear_field(desc_field, xy_soft[..., 0] / CELL, xy_soft[..., 1] / CELL)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
    return xy, desc, torch.where(mask, score, 0.0), mask


# flax's lecun_normal draws from a normal cut at +-2 of its own sigma and
# inflates sigma by 1 / 0.8796 (the std of the cut unit normal), so that
# the drawn kernel has std 1/sqrt(fan_in)
_TRUNC_STD = 0.87962566103423978


def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every dense and convolution layer of ``model`` in place as
    flax does by default: lecun-normal kernels (std 1/sqrt(fan_in), from a
    normal truncated at +-2 sigma) and zero biases. The bits differ from the
    reference's threefry draws; the distribution is the same. Returns
    ``model``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                sigma = fan_in ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=sigma, a=-2 * sigma, b=2 * sigma,
                                      generator=generator)
                m.bias.zero_()
    return model


def init_params(generator: torch.Generator, height: int = 64, width: int = 64) -> SuperPointNet:
    """A SuperPointNet initialised as the reference's ``init_params`` does
    (on the CPU). ``height`` and ``width`` are the reference's dummy input
    size: they shape no parameter."""
    del height, width
    return lecun_init_(SuperPointNet(), generator)
