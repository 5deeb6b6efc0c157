"""Stereo and RGB-D backprojection tools, batched (port of
eacham_tpu/geometry/stereo.py).

  * ``point_from_stereo``: disparity between rectified left/right
    observations -> camera-frame 3-D points;
  * ``point_from_depth``: depth-map lookup -> camera-frame 3-D points;
  * ``hamming_distance`` / ``match_hamming``: all-pairs popcount distance of
    packed binary descriptors and the mutual ratio-test matcher on it.

All of it is plain tensor code, as it is plain ``jnp`` in the reference.
"""

from __future__ import annotations

import torch

# popcount of every byte value: the XOR of two uint8 rows indexes it
_POPCOUNT8 = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.int32)


def point_from_stereo(uv_left: torch.Tensor, u_right: torch.Tensor,
                      intr: torch.Tensor, baseline: float) -> torch.Tensor:
    """Rectified stereo triangulation.

    uv_left: [..., 2] pixels in the left camera; u_right: [...] the matched
    x-coordinate in the right camera; baseline in meters. Returns
    camera-frame points [..., 3]; non-positive disparity yields points at
    huge depth (callers gate on a max-depth threshold).
    """
    disparity = torch.clamp(uv_left[..., 0] - u_right, min=1e-6)
    z = intr[..., 0] * baseline / disparity
    x = (uv_left[..., 0] - intr[..., 2]) / intr[..., 0] * z
    y = (uv_left[..., 1] - intr[..., 3]) / intr[..., 1] * z
    return torch.stack([x, y, z], dim=-1)


def point_from_depth(uv: torch.Tensor, depth_map: torch.Tensor,
                     intr: torch.Tensor, depth_scale: float = 1.0):
    """Depth-map backprojection at integer pixel locations.

    uv: [K, 2]; depth_map: [H, W]. Returns ([K, 3], valid [K]), valid where
    the stored depth is positive.
    """
    H, W = depth_map.shape
    xi = torch.clamp(uv[..., 0].long(), 0, W - 1)
    yi = torch.clamp(uv[..., 1].long(), 0, H - 1)
    z = depth_map[yi, xi] * depth_scale
    x = (uv[..., 0] - intr[..., 2]) / intr[..., 0] * z
    y = (uv[..., 1] - intr[..., 3]) / intr[..., 1] * z
    return torch.stack([x, y, z], dim=-1), z > 0.0


def hamming_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance of packed binary descriptors.

    d1: [K1, B] uint8, d2: [K2, B] uint8 -> [K1, K2] int32: one broadcast
    XOR, a 256-entry popcount table, a sum over the bytes.
    """
    x = torch.bitwise_xor(d1[:, None, :], d2[None, :, :])
    return _POPCOUNT8.to(x.device)[x.long()].sum(-1, dtype=torch.int32)


def match_hamming(d1, d2, mask1, mask2, max_distance: int = 64, ratio: float = 0.8):
    """Mutual ratio-test matching for binary descriptors, the ORB-path
    analogue of ``features.matching.match_pair``. Ties go to the first
    minimum, as ``argmin`` does in the reference. Returns
    ``(best12 [K1] int32, ok [K1] bool)``."""
    dist = hamming_distance(d1, d2).float()
    BIG = 1e9
    dist = torch.where(mask1[:, None] & mask2[None, :], dist, BIG)

    # torch.argmin does not promise the first of equal minima: take the
    # smallest index that holds the minimum
    def first_argmin(x, dim):
        m = x.amin(dim, keepdim=True)
        idx = torch.arange(x.shape[dim], device=x.device)
        shape = [1, 1]
        shape[dim] = -1
        return torch.where(x == m, idx.view(shape), x.shape[dim]).amin(dim)

    best12 = first_argmin(dist, 1)
    d_best = dist.amin(1)
    masked = dist + torch.nn.functional.one_hot(best12, dist.shape[1]) * BIG
    d_second = masked.amin(1)
    best21 = first_argmin(dist, 0)
    ok = ((d_best <= max_distance) & (d_best < ratio * d_second)
          & (best21[best12] == torch.arange(d1.shape[0], device=d1.device)) & mask1)
    return best12.to(torch.int32), ok
