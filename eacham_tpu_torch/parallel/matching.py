"""Sharded exhaustive pair matching (port of eacham_tpu/parallel/matching.py).

The pair axis is split over the mesh's ranks, descriptors are replicated:
each rank launches the batched matcher once on its contiguous block of
pairs, and the blocks are gathered, so every rank returns the full tables
(the reference returns one global array sharded over the mesh).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from eacham_tpu_torch.features.matching import match_all_pairs
from eacham_tpu_torch.parallel.mesh import Mesh, shard_rows


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equally shaped block, concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def match_all_pairs_sharded(
    desc: torch.Tensor,       # [N, K, D] L2-normalized (replicated)
    kp_mask: torch.Tensor,    # [N, K]
    pair_idx: torch.Tensor,   # [P, 2]
    mesh: Mesh,
    ratio: float = 0.8,
    min_matches: int = 30,
    chunk: int = 16,
):
    """Same contract as ``match_all_pairs``, the pairs split over the mesh.
    Padding rows (frame 0 against itself) are matched and cut off."""
    P = pair_idx.shape[0]
    pad, lo, hi = shard_rows(P, mesh)
    padded = torch.cat([pair_idx, pair_idx.new_zeros((pad, 2))]) if pad else pair_idx
    match_j, valid, pair_ok = match_all_pairs(desc, kp_mask, padded[lo:hi], ratio=ratio,
                                              min_matches=min_matches, chunk=chunk)
    if mesh.group is None:
        return match_j, valid, pair_ok
    # (collectives move bool tensors as uint8)
    match_j = _gather(match_j, mesh)
    valid = _gather(valid.to(torch.uint8), mesh).bool()
    pair_ok = _gather(pair_ok.to(torch.uint8), mesh).bool()
    return match_j[:P], valid[:P], pair_ok[:P]
