"""Deep frontend drop-in: SuperPoint-class extraction + LightGlue-class
pair matching with the classical pipeline's contracts (port of
eacham_tpu/features/deep/frontend.py).

``extract_deep_batch`` emits (xy, desc, score, mask) in the classical
layout, and ``build_match_tables_deep`` produces the 6-tuple that
``initialize_sfm`` takes as ``match_tables`` — so the pipeline runs
unchanged on either frontend. The entry points run on the card unless the
caller passes ``device="cpu"``.

Spans of ``utils.timer`` (recorded only under a profiler): ``features.deep.extract``
around ``extract_deep_batch`` (counts ``frames``, ``chunks``, ``readbacks``), and
``sfm.matches.deep`` around ``build_match_tables_deep`` with the children
``.pairs`` (``candidate_pairs``, ``bucket_pairs`` and the pair list's upload:
``readbacks``), ``.match`` (``match_all_pairs_deep``: ``pairs``, the real ones,
``rows``, the pairs computed with the chunk's padding, ``attention_calls``,
``readbacks``) and ``.verify`` (epipolar verification, the gate and the
inverse tables: ``readbacks``, the essential-matrix refits' waits, counted in
``geometry.epipolar``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from eacham_tpu_torch import convert
from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.features.deep import lightglue as lg
from eacham_tpu_torch.features.deep import superpoint as sp
from eacham_tpu_torch.sfm.matches import (
    all_pairs_index, bucket_pairs, candidate_pairs, invert_matches,
    verify_matches_epipolar,
)
from eacham_tpu_torch.utils import timer

# Pairs per pass of the matcher. The reference takes 4 to bound its
# activations; per-pair results do not depend on the chunk beyond summation
# order, and on the card 32 pairs (2048 thread blocks per attention launch,
# about 1 GB of [chunk, K, K] assignment temporaries at K = 1024) fill the
# 132 SMs and cut the launches eightfold.
PAIR_CHUNK = 32


def load_frontend_params(weights_dir=None, generator: torch.Generator | None = None,
                         device: str | torch.device | None = "cuda"):
    """Load the shipped (or ``weights_dir``-supplied) deep-frontend weights.

    Returns ``(superpoint, matcher, n_layers)``: the two modules on
    ``device`` in eval mode; ``n_layers`` comes from ``lightglue.meta``
    (3 without one). Each module's ``weights_path`` names the ``.npz`` it
    was loaded from, or is None where that file is missing and the module
    was initialised at random from ``generator`` (seed 0 by default).
    """
    dev = resolve_device(device)
    wdir = Path(weights_dir) if weights_dir else (
        Path(__file__).resolve().parents[3] / "weights")
    generator = generator or torch.Generator().manual_seed(0)

    n_layers = 3
    meta = wdir / "lightglue.meta"
    if meta.exists():
        for line in meta.read_text().splitlines():
            if line.startswith("n_layers"):
                n_layers = int(line.split("=")[1])

    def one(fname, from_numpy, init):
        path = wdir / fname
        if path.exists():
            with np.load(path) as data:
                model = from_numpy({k: data[k] for k in data.files})
            model.weights_path = str(path)
        else:
            model = init().eval()
            model.weights_path = None
        return model.to(dev).requires_grad_(False)

    superpoint = one("superpoint.npz", convert.superpoint_from_numpy,
                     lambda: sp.init_params(generator))
    matcher = one("lightglue.npz",
                  lambda flat: convert.lightglue_from_numpy(flat, n_layers),
                  lambda: lg.init_params(generator, n_layers=n_layers))
    return superpoint, matcher, n_layers


def _on_device(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``as_tensor``, counted as a read-back (``utils.timer``) where ``x`` is not
    a tensor on ``dev``'s kind of device: on a card, an upload from pageable
    memory waits for it."""
    if not (torch.is_tensor(x) and x.device.type == dev.type):
        timer.add("readbacks")
    return as_tensor(x, dev, dtype)


def pad_images_for_conv(images: torch.Tensor) -> torch.Tensor:
    """Zero-pad [N, H, W] so H, W are multiples of the encoder stride."""
    N, H, W = images.shape
    H8 = -(-H // sp.CELL) * sp.CELL
    W8 = -(-W // sp.CELL) * sp.CELL
    if (H8, W8) == (H, W):
        return images
    out = images.new_zeros((N, H8, W8))
    out[:, :H, :W] = images
    return out


@torch.no_grad()
def extract_deep_batch(model: sp.SuperPointNet, images, max_keypoints: int = 512,
                       score_threshold: float = sp.SCORE_THRESHOLD,
                       frame_chunk: int = 8,
                       device: str | torch.device | None = "cuda"):
    """SuperPoint extraction on a frame batch (classical-contract output),
    ``frame_chunk`` frames at a time: the first 64-channel activation of 100
    frames at 512x384 alone is 5 GB. The frame batch moves the convolutions'
    summation order, and with it keypoints by under 1e-3 px."""
    dev = resolve_device(device)
    with timer.span("features.deep.extract") as span:
        images = pad_images_for_conv(_on_device(images, dev, torch.float32))
        span.add("frames", images.shape[0])
        outs = []
        for s in range(0, images.shape[0], frame_chunk):
            outs.append(sp.extract_deep(model, images[s:s + frame_chunk],
                                        max_keypoints=max_keypoints,
                                        score_threshold=score_threshold))
            span.add("chunks")
        return tuple(torch.cat([o[i] for o in outs]) for i in range(4))


@torch.no_grad()
def match_all_pairs_deep(
    model: lg.LightGlueMatcher,
    xy: torch.Tensor,         # [N, K, 2] pixels
    desc: torch.Tensor,       # [N, K, 256]
    kp_mask: torch.Tensor,    # [N, K]
    pair_idx: torch.Tensor,   # [P, 2]
    image_size: tuple,        # (w, h) for kp normalization
    min_matches: int = 30,
    chunk: int = PAIR_CHUNK,
    threshold: float = lg.MATCH_THRESHOLD,
):
    """Pair matching through the attentional matcher, ``chunk`` pairs per
    pass (a host loop where the reference scans). Same output contract as
    features.matching.match_all_pairs; the tensors and the model must share
    a device."""
    P = pair_idx.shape[0]
    K = xy.shape[1]
    w, h = image_size
    kps_n = lg.normalize_keypoints(xy, float(w), float(h))
    pi = pair_idx.long()
    pad = (-P) % chunk
    if pad:
        pi = torch.cat([pi, pi.new_zeros((pad, 2))])
    timer.add("rows", pi.shape[0])
    mj, mv = [], []
    for s in range(0, pi.shape[0], chunk):
        i, j = pi[s:s + chunk, 0], pi[s:s + chunk, 1]
        idx, valid, _ = lg.match_deep(model, kps_n[i], desc[i], kp_mask[i],
                                      kps_n[j], desc[j], kp_mask[j], threshold=threshold)
        mj.append(idx)
        mv.append(valid)
    if not mj:
        empty = torch.zeros((0, K), dtype=torch.int32, device=xy.device)
        return empty, empty.bool(), empty.new_zeros((0,)).bool()
    match_j = torch.cat(mj)[:P]
    match_valid = torch.cat(mv)[:P]
    return match_j, match_valid, match_valid.sum(-1) > min_matches


@torch.no_grad()
def build_match_tables_deep(
    model: lg.LightGlueMatcher,
    xy,                       # [N, K, 2]
    desc,                     # [N, K, 256]
    kp_mask,                  # [N, K]
    image_size: tuple,        # (w, h)
    min_matches: int = 30,
    chunk: int = PAIR_CHUNK,
    pair_window: int = 0,
    retrieval_k: int = 3,
    ladder: bool = True,
    verify: tuple | None = None,   # (intr, generator, px_thr, n_hyp)
    threshold: float = lg.MATCH_THRESHOLD,
    device: str | torch.device | None = "cuda",
):
    """Production-shaped deep match graph: the same candidate-pair
    windowing, size bucketing, epipolar verification and inverse tables as
    the classical ``build_match_tables``.

    Returns the 6-tuple ``initialize_sfm`` accepts as ``match_tables``:
    (pair_idx, pair_ok, match_ij, valid_ij, match_ji, valid_ji), on
    ``device``; P includes the bucket padding.
    """
    dev = resolve_device(device)
    with timer.span("sfm.matches.deep"):
        xy = _on_device(xy, dev, torch.float32)
        desc = _on_device(desc, dev, torch.float32)
        kp_mask = _on_device(kp_mask, dev, torch.bool)
        with timer.span("sfm.matches.deep.pairs") as span:
            if pair_window > 0:
                # the [N, N] frame similarity is read back to the host
                span.add("readbacks")
                pairs = candidate_pairs(desc, kp_mask, window=pair_window,
                                        retrieval_k=retrieval_k, ladder=ladder)
            else:
                pairs = all_pairs_index(xy.shape[0])
            pair_idx = timer.readback(torch.as_tensor, bucket_pairs(pairs), device=dev)
        with timer.span("sfm.matches.deep.match") as span:
            span.add("pairs", int((pairs[:, 0] < pairs[:, 1]).sum()))
            match_ij, valid_ij, pair_ok = match_all_pairs_deep(
                model, xy, desc, kp_mask, pair_idx, image_size,
                min_matches=min_matches, chunk=chunk, threshold=threshold)
        with timer.span("sfm.matches.deep.verify"):
            pair_ok = pair_ok & (pair_idx[:, 0] < pair_idx[:, 1])
            if verify is not None:
                intr, generator, px_thr, n_hyp = verify
                valid_ij = verify_matches_epipolar(
                    xy, pair_idx, match_ij, valid_ij, _on_device(intr, dev, torch.float32),
                    generator, px_threshold=px_thr, n_hyp=n_hyp)
                pair_ok = pair_ok & (valid_ij.sum(-1) > min_matches)
            valid_ij = valid_ij & pair_ok[:, None]
            match_ji, valid_ji = invert_matches(match_ij, valid_ij)
    return pair_idx, pair_ok, match_ij, valid_ij, match_ji, valid_ji


@torch.no_grad()
def match_images_e2e(
    superpoint: sp.SuperPointNet,
    matcher: lg.LightGlueMatcher,
    images,                   # [2, H, W] float32 in [0, 1]
    max_keypoints: int = 512,
    threshold: float = lg.MATCH_THRESHOLD,
    score_threshold: float = sp.SCORE_THRESHOLD,
    device: str | torch.device | None = "cuda",
):
    """End-to-end deep matching: two images in, matched keypoint pairs out.

    Returns ``(uv0 [K, 2], uv1 [K, 2], valid [K], mscore [K])``: pixel
    coordinates of each matched pair (rows where ``valid`` is False are
    garbage).
    """
    dev = resolve_device(device)
    images = as_tensor(images, dev, torch.float32)
    _, H, W = images.shape
    xy, desc, _, mask = extract_deep_batch(
        superpoint, images, max_keypoints=max_keypoints,
        score_threshold=score_threshold, device=dev)
    kps_n = lg.normalize_keypoints(xy, float(W), float(H))
    idx, valid, scores = lg.match_deep(
        matcher, kps_n[:1], desc[:1], mask[:1], kps_n[1:], desc[1:], mask[1:],
        threshold=threshold)
    mscore = torch.where(valid[0, :, None], scores[0], 0.0).amax(-1)
    return xy[0], xy[1][idx[0].long()], valid[0], mscore
