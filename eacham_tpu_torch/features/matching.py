"""Descriptor matching of frame pairs (port of ``match_pair`` and
``match_all_pairs``, eacham_tpu/features/matching.py).

For L2-normalized descriptors the distance matrix is d^2 = 2 - 2 D1 D2^T,
so each pair is one [K, 256] x [256, K] product reduced to a top-2 ratio
test plus a mutual check. On the card every call takes the batched CUDA
kernel, whatever the pair count (the reference switched to its Pallas
kernel only from 1024 pairs up), a single pair too; on the CPU the
kernel's plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eacham_tpu_torch.ops.match_kernel import match_pairs_fused


def match_pair(
    d1: torch.Tensor,         # [K1, D] L2-normalized descriptors
    d2: torch.Tensor,         # [K2, D]
    mask1: torch.Tensor,      # [K1] bool
    mask2: torch.Tensor,      # [K2] bool
    ratio: float = 0.8,
):
    """Mutual Lowe-ratio matching of one pair: the per-pair function of
    ``match_all_pairs`` (bf16 products, packed top-2, the ratio test both
    ways, the mutual check). Returns ``(best_j [K1] int32, valid [K1]
    bool)``; best_j is garbage where valid is False.

    The two sets go into a two-row table, padded to the larger K with dead
    keypoints, and through the batched matcher as the one pair (0, 1): one
    launch of its kernel on the card. Padding changes neither the
    quantization nor the live lanes' indices.
    """
    K1, K2 = d1.shape[0], d2.shape[0]
    K = max(K1, K2)
    desc = torch.stack([F.pad(d1, (0, 0, 0, K - K1)), F.pad(d2, (0, 0, 0, K - K2))])
    mask = torch.stack([F.pad(mask1.bool(), (0, K - K1)), F.pad(mask2.bool(), (0, K - K2))])
    pair = torch.arange(2, dtype=torch.int32, device=d1.device).view(1, 2)   # (no copy)
    match_j, valid = match_pairs_fused(desc, mask, pair, ratio)
    return match_j[0, :K1], valid[0, :K1]


def match_all_pairs(
    desc: torch.Tensor,       # [N, K, D] L2-normalized
    kp_mask: torch.Tensor,    # [N, K] bool
    pair_idx: torch.Tensor,   # [P, 2] (i, j) frame indices, i < j
    ratio: float = 0.8,
    min_matches: int = 30,
    chunk: int = 256,
):
    """Returns ``(match_j [P, K] int32, match_valid [P, K] bool,
    pair_ok [P] bool)``: row p maps keypoints of frame pair_idx[p, 0] to
    keypoints of frame pair_idx[p, 1]; pair_ok is the "> min_matches
    survivors" gate. ``i < j`` also gates bucket-padding dummy rows
    (i == j == 0). ``chunk`` bounds the plain version's live similarity
    memory (chunk * K * K floats)."""
    match_j, match_valid = match_pairs_fused(desc, kp_mask, pair_idx, ratio,
                                             chunk=chunk)
    pair_ok = (match_valid.sum(-1) > min_matches) \
        & (pair_idx[:, 0] < pair_idx[:, 1])
    return match_j, match_valid, pair_ok
