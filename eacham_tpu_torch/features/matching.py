"""Exhaustive descriptor matching of frame pairs (port of
``match_all_pairs``, eacham_tpu/features/matching.py).

For L2-normalized descriptors the distance matrix is d^2 = 2 - 2 D1 D2^T,
so each pair is one [K, 256] x [256, K] product reduced to a top-2 ratio
test plus a mutual check. On the card every call takes the batched CUDA
kernel, whatever the pair count (the reference switched to its Pallas
kernel only from 1024 pairs up); on the CPU the kernel's plain version.
"""

from __future__ import annotations

import torch

from eacham_tpu_torch.ops.match_kernel import match_pairs_fused


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
