"""Match-graph construction (port of eacham_tpu/sfm/matches.py).

The whole graph is three dense tables (pair index, forward map, inverse
map) built from the batched matcher's output, with every edge verified by
an essential-matrix RANSAC batched over pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from eacham_tpu_torch.geometry.camera import pixel_to_normalized
from eacham_tpu_torch.geometry.epipolar import estimate_essential
from eacham_tpu_torch.parallel.matching import match_all_pairs_sharded
from eacham_tpu_torch.parallel.mesh import local_mesh


def all_pairs_index(n_frames: int) -> np.ndarray:
    """Host-side [P, 2] (i, j) enumeration, i < j."""
    ii, jj = np.triu_indices(n_frames, k=1)
    return np.stack([ii, jj], -1).astype(np.int32)


def candidate_pairs(
    desc: torch.Tensor,        # [N, K, D] L2-normalized descriptors
    kp_mask: torch.Tensor,     # [N, K]
    window: int = 10,
    retrieval_k: int = 5,
    ladder: bool = True,
) -> np.ndarray:
    """Candidate-pair subset: sequential window + ladder + retrieval.

    Every frame is paired with its ``window`` successors (video order),
    with frames at exponentially spaced offsets (2 * window, 4 * window,
    ...: the "ladder", which constrains the trajectory at all scales for
    O(N log N) pairs), and with its ``retrieval_k`` most similar non-window
    frames by pooled-descriptor similarity (one [N, D] x [D, N] product),
    which restores loop-closure edges the ladder misses.

    Returns [P, 2] int32 on the host with i < j, sorted, deduplicated.
    """
    N = desc.shape[0]
    if window <= 0 or window >= N:
        return all_pairs_index(N)

    # global frame descriptor: masked mean of local descriptors, renormalized
    m = kp_mask[..., None].to(desc.dtype)
    g = (desc * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    g = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-8)
    sim = (g @ g.t()).cpu().numpy()

    ii = np.repeat(np.arange(N), window)
    jj = ii + np.tile(np.arange(1, window + 1), N)
    keep = jj < N
    pairs = [np.stack([ii[keep], jj[keep]], -1)]

    if ladder:
        off = 2 * window
        while off < N:
            a = np.arange(N - off)
            pairs.append(np.stack([a, a + off], -1))
            off *= 2

    if retrieval_k > 0:
        # mask self + window band, then take top-k most similar per frame
        d = np.abs(np.arange(N)[:, None] - np.arange(N)[None, :])
        sim = np.where(d <= window, -np.inf, sim)
        k = min(retrieval_k, max(N - window - 1, 0))
        if k > 0:
            top = np.argpartition(-sim, k - 1, axis=1)[:, :k]   # [N, k]
            a = np.repeat(np.arange(N), k)
            b = top.reshape(-1)
            ok = np.isfinite(sim[a, b])
            a, b = a[ok], b[ok]
            pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], -1))

    allp = np.concatenate(pairs, axis=0).astype(np.int32)
    return np.unique(allp, axis=0)


def invert_matches(match_ij: torch.Tensor, valid_ij: torch.Tensor):
    """Invert kp_i -> kp_j maps into kp_j -> kp_i maps by scatter.

    match_ij [P, K] int32, valid_ij [P, K] bool -> (match_ji [P, K] int32,
    valid_ji [P, K] bool). Valid matches are mutual, hence injective; the
    invalid ones all land in a dump column that is cut off.
    """
    P, K = match_ij.shape
    tgt = torch.where(valid_ij, match_ij.long(), K)
    src = torch.arange(K, dtype=torch.int32, device=match_ij.device).expand(P, K)
    inv = torch.full((P, K + 1), -1, dtype=torch.int32, device=match_ij.device)
    inv = inv.scatter(1, tgt, src)[:, :-1]
    return inv, inv >= 0


def verify_matches_epipolar(
    keypoints: torch.Tensor,   # [N, K, 2] pixels
    pair_idx: torch.Tensor,    # [P, 2]
    match_ij: torch.Tensor,    # [P, K]
    valid_ij: torch.Tensor,    # [P, K]
    intr: torch.Tensor,        # [4]
    generator: torch.Generator | None = None,
    px_threshold: float = 4.0,
    n_hyp: int = 64,
    chunk: int = 1024,
    sample_idx: torch.Tensor | None = None,   # [P, n_hyp, 8]
):
    """Geometric verification of every match edge: per-pair essential-matrix
    MSAC keeps only epipolar-consistent matches. ``chunk`` pairs are
    verified in one batched pass.

    Returns the filtered ``valid_ij``.
    """
    P = match_ij.shape[0]
    f_mean = 0.5 * (intr[0] + intr[1])
    thr = torch.full_like(f_mean, px_threshold) / f_mean
    pi = pair_idx.long()
    out = []
    for s in range(0, P, chunk):
        p = pi[s:s + chunk]
        v = valid_ij[s:s + chunk]
        uv1 = keypoints[p[:, 0]]
        uv2 = torch.gather(keypoints[p[:, 1]], 1,
                           match_ij[s:s + chunk].long()[..., None].expand(-1, -1, 2))
        xy1 = pixel_to_normalized(uv1, intr)
        xy2 = pixel_to_normalized(uv2, intr)
        res = estimate_essential(
            xy1, xy2, v, thr, n_hyp=n_hyp, generator=generator,
            sample_idx=None if sample_idx is None else sample_idx[s:s + chunk])
        out.append(v & res.inliers)
    if not out:
        return valid_ij
    return torch.cat(out)


def _post_verify_gate(pair_ok, valid_ij, min_matches):
    """Min-survivor gate after epipolar verification."""
    pair_ok = pair_ok & (valid_ij.sum(-1) > min_matches)
    return pair_ok, valid_ij & pair_ok[:, None]


def bucket_pairs(pair_idx: np.ndarray) -> np.ndarray:
    """Pad the pair axis on the host with (0, 0) dummy rows up to a
    multiple of 64 (up to 1024 pairs) or 512 (beyond); the dummies are
    gated out by ``i < j`` in the matcher."""
    pair_idx = np.asarray(pair_idx)
    P0 = pair_idx.shape[0]
    step = 64 if P0 <= 1024 else 512
    pad = (-P0) % step
    if pad:
        pair_idx = np.concatenate(
            [pair_idx, np.zeros((pad, 2), pair_idx.dtype)], axis=0)
    return pair_idx


def build_match_tables(
    desc: torch.Tensor,        # [N, K, D] L2-normalized descriptors
    kp_mask: torch.Tensor,     # [N, K]
    ratio: float = 0.8,
    min_matches: int = 30,
    chunk: int = 16,
    verify: tuple | None = None,   # (keypoints, intr, generator, px_thr, n_hyp)
    verify_sample_idx: torch.Tensor | None = None,
    pair_idx: np.ndarray | None = None,
    mesh=None,
):
    """Exhaustive matching + epipolar verification + inverse tables.

    ``chunk`` bounds the plain matcher's memory on the CPU (the kernel
    takes every pair in one launch). ``pair_idx`` (host [P, 2], i < j)
    overrides the all-pairs enumeration with a candidate subset. The pairs
    are split over the ranks of ``mesh`` (``parallel.make_mesh``; default:
    this process alone) by ``parallel.match_all_pairs_sharded``, and every
    rank gets the full tables.

    Returns ``(pair_idx [P, 2] int32, pair_ok, match_ij, valid_ij,
    match_ji, valid_ji)`` on the descriptors' device — P includes the
    bucket padding.
    """
    if pair_idx is None:
        pair_idx = all_pairs_index(desc.shape[0])
    pair_idx = torch.as_tensor(bucket_pairs(pair_idx), device=desc.device)
    match_ij, valid_ij, pair_ok = match_all_pairs_sharded(
        desc, kp_mask, pair_idx, mesh or local_mesh(desc.device), ratio=ratio,
        min_matches=min_matches, chunk=chunk)
    if verify is not None:
        kps, intr, generator, px_thr, n_hyp = verify
        valid_ij = verify_matches_epipolar(
            kps, pair_idx, match_ij, valid_ij, intr, generator,
            px_threshold=px_thr, n_hyp=n_hyp, sample_idx=verify_sample_idx)
        pair_ok, valid_ij = _post_verify_gate(pair_ok, valid_ij, min_matches)
    else:
        valid_ij = valid_ij & pair_ok[:, None]
    match_ji, valid_ji = invert_matches(match_ij, valid_ij)
    return pair_idx, pair_ok, match_ij, valid_ij, match_ji, valid_ji


def observers_of_frame(
    frame,                     # int or [] int tensor — the "current" frame c
    pair_rows: torch.Tensor,   # [D] — frame_pair_table[c], -1 padded
    pair_idx: torch.Tensor,    # [P, 2]
    pair_ok: torch.Tensor,     # [P]
    match_ij: torch.Tensor,    # [P, K]
    valid_ij: torch.Tensor,
    match_ji: torch.Tensor,
    valid_ji: torch.Tensor,
):
    """For every keypoint k of frame c: the matched keypoint in each of c's
    candidate neighbours, compacted to the frame's degree D.

    Returns ``(obs_frame [D] int64, obs_kp [D, K] int64, obs_on [D, K])``
    where obs_kp[d, k] is the keypoint of frame obs_frame[d] matched to
    keypoint k of frame c. ``pair_rows`` lists neighbours in ascending frame
    order, so first-True selections over axis 0 prefer earlier frames.
    """
    pid = torch.clamp(pair_rows.long(), min=0)
    has_edge = (pair_rows >= 0) & pair_ok[pid]
    # slot d comes from the forward table when c is the pair's "i" slot,
    # from the inverse table otherwise
    pi = pair_idx[pid].long()
    c_is_i = pi[:, 0] == frame
    obs_frame = torch.where(c_is_i, pi[:, 1], pi[:, 0])
    obs_frame = torch.where(has_edge, obs_frame, frame)
    obs_kp = torch.where(c_is_i[:, None], match_ij[pid], match_ji[pid]).long()
    obs_on = torch.where(c_is_i[:, None], valid_ij[pid], valid_ji[pid]) & has_edge[:, None]
    return obs_frame, obs_kp, obs_on
