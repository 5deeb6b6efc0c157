"""The numbers that decide ``correct``, each worked out by the plain
reference from a request's inputs and judged against the program's
outputs.

What the reference re-derives from the inputs alone: the frontend's
keypoints and descriptors (from the images), the true relative poses and
the true trajectory (from the generator's ground truth). Where a stage's
input is the program's own earlier output, the reference follows the
program from there (the matches are re-derived from the program's
descriptors, the poses' optimum from the program's map) and the earlier
stage is judged on its own.

The frontend's numbers and the reference matcher belong to the
configuration's frontend kind (``spec["reference"]``, a module of
``reference/frontends/``); a configuration without a frontend (tracks) is
matched by ``run_sfm``'s own rule (``matcher.reference_matches``). The
pairs, the map and the trajectory are judged alike for every kind.

``control`` (the configuration's ``control``: a setting a stage) puts the
reference in the program's place at each stage it names, one precision
below the one the configuration states or with one of its stated
guarantees broken, and judges that instead: ``frontend`` and ``matcher``
as the kind's reference module reads them (the DoG kind: ``frontend:
"tf32"``, TF32 convolutions; ``matcher: "fp8"``, fp8 descriptors, or
``"no_ratio"``, no ratio test), ``poses: "tf32"`` (the refined poses stored
at TF32 precision), ``points: "tf32"`` (the refined landmarks stored at
TF32 precision).
"""

from __future__ import annotations

import numpy as np
import torch

from sfmbench.reference import frontend, geometry, matcher

PAIR_RADIUS_PX = 0.5      # keypoints of the two sides pair when mutually nearest within this


def _pair_keypoints(a, b):
    """Mutually nearest keypoints of a [n, 2] and b [m, 2] within
    PAIR_RADIUS_PX. Returns (ia, ib, distances) of the pairs."""
    if len(a) == 0 or len(b) == 0:
        e = torch.zeros(0, dtype=torch.long, device=a.device)
        return e, e, torch.zeros(0, dtype=torch.float64, device=a.device)
    d = torch.cdist(a, b)
    nb = d.argmin(1)
    na = d.argmin(0)
    ia = torch.arange(len(a), device=a.device)
    ok = (na[nb] == ia) & (d[ia, nb] < PAIR_RADIUS_PX)
    return ia[ok], nb[ok], d[ia[ok], nb[ok]]


def compare_features(xy, desc, mask, rxy, rdesc, rlive) -> dict:
    """Features of the same frames, [F, K, 2] keypoints, [F, K, D]
    descriptors and [F, K] masks, against the reference's (``rxy``,
    ``rdesc``, ``rlive``). Returns kp_unpaired (share of both sides'
    keypoints left unpaired), kp_gap_px and desc_gap (99th percentiles over
    the paired keypoints)."""
    unpaired, total, gaps, dgaps = 0, 0, [], []
    for f in range(len(rxy)):
        a = xy[f][mask[f]].double()
        b = rxy[f][rlive[f]]
        ia, ib, dist = _pair_keypoints(a, b)
        unpaired += len(a) + len(b) - 2 * len(ia)
        total += len(a) + len(b)
        gaps.append(dist)
        da = desc[f][mask[f]].double()[ia]
        dgaps.append((da - rdesc[f][rlive[f]][ib]).abs().amax(1))
    gaps, dgaps = torch.cat(gaps), torch.cat(dgaps)

    def p99(x):
        return float(torch.quantile(x, 0.99)) if len(x) else float("inf")

    return {"kp_unpaired": unpaired / max(total, 1), "kp_gap_px": p99(gaps),
            "desc_gap": p99(dgaps)}


def ladder_offsets(n: int, window: int) -> list[int]:
    """The ladder's offsets over ``n`` frames, as ``sfm.matches.candidate_pairs``
    steps them: 2 * window, 4 * window, ... while below ``n``."""
    offs, off = [], 2 * window
    while window > 0 and off < n:
        offs.append(off)
        off *= 2
    return offs


def stated_pairs(n: int, window: int, retrieval_k: int, ladder: bool = False,
                 symmetric: bool = False):
    """The candidate pairs the cell states over ``n`` frames: every i < j
    where ``window`` is 0 (exhaustive matching); otherwise each frame j
    paired with its ``window`` predecessors, with ``ladder`` the pairs
    (i, i + d) for d in ``ladder_offsets`` (stated exactly), plus the pairs
    the program picks by retrieval, stated as a count of slots a frame:
    ``retrieval_k`` pairs (t, j) with t < j - window for each frame j (the
    stream's rule), or, ``symmetric``, ``retrieval_k`` pairs (a, b) with
    |a - b| > window, on either side of each frame a
    (``sfm.matches.candidate_pairs``' rule), as many as there are such
    frames. Returns (the stated pairs [S, 2], the retrieval slots of each
    frame [n])."""
    j = torch.arange(n)
    if window == 0:
        i, jj = torch.triu_indices(n, n, 1)
        return torch.stack([i, jj], 1), torch.zeros(n, dtype=torch.long)
    d = torch.arange(1, window + 1)
    i = j[:, None] - d[None, :]
    keep = i >= 0
    pairs = torch.stack([i[keep], j[:, None].expand_as(i)[keep]], 1)
    if ladder:
        rungs = [torch.stack([torch.arange(n - off), torch.arange(off, n)], 1)
                 for off in ladder_offsets(n, window)]
        pairs = torch.cat([pairs, *rungs])
    before = (j - window).clamp(min=0)
    if symmetric:
        slots = (before + (n - 1 - window - j).clamp(min=0)).clamp(max=retrieval_k)
    else:
        slots = before.clamp(max=retrieval_k)
    return pairs, slots


def judge_pairs(pair_idx, n: int, window: int, retrieval_k: int, ladder: bool = False,
                symmetric: bool = False) -> dict:
    """pairs_missing: share of the stated candidate pairs (``stated_pairs``)
    that the program's pair list lacks, a retrieval slot left unfilled
    counting as one. A slot is filled by a pair of the program's list wider
    than ``window``: the stream's by one ending at the frame, a
    ``symmetric`` rule's by one at either end; a ladder pair (with
    ``ladder``) fills none.

    Where ``candidate_pairs`` picks a ladder pair by retrieval too, it keeps
    the one pair, and this rule reads that slot as empty unless another
    pair of the frame fills it: a world whose most similar frames beyond the
    window lie at a ladder offset reads above 0 on a sound program. In a
    sequence whose frames grow less alike with distance, a frame's picks
    reach the first offset (2 * window) only where fewer than
    ``retrieval_k`` frames lie nearer beyond the window on its sides;
    elsewhere only a revisit at an offset's distance does."""
    real = pair_idx[:, 0] < pair_idx[:, 1]
    have = pair_idx[real].long().cpu()
    want, slots = stated_pairs(n, window, retrieval_k, ladder, symmetric)
    key = have[:, 0] * n + have[:, 1]
    lacking = int((~torch.isin(want[:, 0] * n + want[:, 1], key)).sum())
    if retrieval_k:
        gap = have[:, 1] - have[:, 0]
        far = gap > window
        if ladder:
            far &= ~torch.isin(gap, torch.tensor(ladder_offsets(n, window), dtype=torch.long))
        ends = torch.cat([have[far, 0], have[far, 1]]) if symmetric else have[far, 1]
        got = torch.zeros(n, dtype=torch.long).index_add_(
            0, ends, torch.ones(len(ends), dtype=torch.long))
        lacking += int((slots - got).clamp(min=0).sum())
    return {"pairs_missing": lacking / max(len(want) + int(slots.sum()), 1)}


def judge_matches(kps, pairs, pm, pv, rj, rv, poses_gt, intr, min_matches,
                  consistent_px, epi_px):
    """The verified match graph against the reference matcher's matches
    (``rj``, ``rv``: [P, K], on the program's real pairs [P, 2]) and against
    the true epipolar geometry; ``pm``, ``pv``: the program's matches on
    those pairs, or the control's in their place (``judge_pairs`` holds the
    pairs to the stated ones).

    match_extra: share of the program's matches that are not the reference's.
    match_missing: share of the reference's matches that the truth bears out
    (Sampson distance under ``consistent_px``), on pairs holding more than
    twice ``min_matches`` of them, that the program lacks. epi_bad: share of
    the program's matches farther than ``epi_px`` from the true epipolar line."""
    T = torch.as_tensor(poses_gt, dtype=torch.float64, device=kps.device)
    kps = kps.double()
    Ti, Tj = T[pairs[:, 0]], T[pairs[:, 1]]
    uv_i = kps[pairs[:, 0]]

    def sampson(j):
        uv_j = torch.gather(kps[pairs[:, 1]], 1, j[..., None].expand(-1, -1, 2))
        return geometry.sampson_px(uv_i, uv_j, Ti, Tj, intr)

    ref_true = rv & (sampson(rj) < consistent_px)
    strong = ref_true.sum(1) > 2 * min_matches
    want = ref_true & strong[:, None]
    same = pv & rv & (pm == rj)
    n_prog = int(pv.sum())
    return {"match_extra": float((pv & ~same).sum()) / max(n_prog, 1),
            "match_missing": float((want & ~same).sum()) / max(int(want.sum()), 1),
            "epi_bad": float((pv & (sampson(pm) > epi_px)).sum()) / max(n_prog, 1)}


def map_observations(scene):
    """The map's observations: (camera, landmark, pixel) of every keypoint of
    a registered frame linked to a valid landmark that two or more such
    keypoints observe (one seen once is not measured)."""
    valid = scene["pose_valid"].bool()
    kp2lm = scene["kp2lm"].long()
    lm_valid = scene["lm_valid"].bool()
    obs = (kp2lm >= 0) & scene["kp_mask"].bool() & valid[:, None]
    obs &= lm_valid[kp2lm.clamp(min=0)]
    seen = torch.zeros(lm_valid.shape[0], dtype=torch.long, device=obs.device)
    seen.index_add_(0, kp2lm[obs], torch.ones_like(kp2lm[obs]))
    obs &= seen[kp2lm.clamp(min=0)] >= 2
    cam, k = torch.nonzero(obs, as_tuple=True)
    return cam, kp2lm[cam, k], scene["keypoints"][cam, k].double()


def judge_map(scene, control=None, points_control=None, firm=geometry.POINT_FIRM):
    """How far the bundle-adjusted map lies from the optimum of its robust
    reprojection cost, one side held at a time: pose_gain, the relative
    drop of that cost that per-camera Gauss-Newton steps find from the
    program's poses with the landmarks held, and point_gain, the drop that
    per-landmark steps find from the program's landmarks with the poses
    held, along the directions the observations fix firmly
    (``geometry.refine_points``). A bundle-adjusted map gives almost none
    of either. (Steps over the whole map at once are not taken: a landmark
    seen from nearby views slides along its rays together with the poses at
    almost no cost, and the program's BA holds it by a prior the map does
    not keep.)"""
    cam, pt, uv = map_observations(scene)
    pose = scene["pose"].double()
    R, t = pose[:, :3, :3], pose[:, :3, 3]
    X = scene["points"].double()
    intr = scene["intr"].double()
    free = scene["pose_valid"].bool() & ~scene["pose_fixed"].bool()
    if control == "tf32":
        R, t = geometry.refine_poses(R, t, X, intr, cam, pt, uv, free)
        R, t = frontend.round_tf32(R).double(), frontend.round_tf32(t).double()
    c0 = geometry.map_cost(R, t, X, intr, cam, pt, uv)
    R1, t1 = geometry.refine_poses(R, t, X, intr, cam, pt, uv, free)
    c1 = geometry.map_cost(R1, t1, X, intr, cam, pt, uv)
    pose = scene["pose"].double()
    R, t = pose[:, :3, :3], pose[:, :3, 3]
    if points_control == "tf32":
        X = geometry.refine_points(R, t, X, intr, cam, pt, uv, firm=None)
        X = frontend.round_tf32(X).double()
    p0 = geometry.map_cost(R, t, X, intr, cam, pt, uv)
    X1 = geometry.refine_points(R, t, X, intr, cam, pt, uv, firm=firm)
    p1 = geometry.map_cost(R, t, X1, intr, cam, pt, uv)
    return {"pose_gain": (c0 - c1) / c0 if c0 > 0 else float("inf"),
            "point_gain": (p0 - p1) / p0 if p0 > 0 else float("inf")}


def judge_request(out: dict, truth: dict, spec: dict, rng: np.random.Generator,
                  control: dict | None = None) -> dict:
    """Every number of one request. ``out``: the program's features (xy,
    desc, mask) and scene fields; ``truth``: images (or None), poses, intr;
    ``spec``: ``harness.check_spec``'s; ``control``: see above."""
    control = control or {}
    scene = out["scene"]
    valid = scene["pose_valid"].bool().cpu().numpy()
    n = len(valid)
    nums = {"unregistered": float(n - valid.sum()),
            "ate": geometry.ate(scene["pose"].double().cpu().numpy()[valid],
                                truth["poses"][valid])}
    fe, ref = spec.get("frontend"), spec.get("reference")
    if fe is not None and truth.get("images") is not None:
        frames = np.sort(rng.choice(n, size=min(spec["frontend_frames"], n), replace=False))
        images = torch.as_tensor(truth["images"], device=out["xy"].device)
        nums.update(ref.judge_frontend(images, out, torch.as_tensor(frames, device=images.device),
                                       fe, control.get("frontend")))
    pairs = spec["pairs"]
    nums.update(judge_pairs(scene["pair_idx"], n, pairs["window"], pairs["retrieval_k"],
                            pairs.get("ladder", False), pairs.get("symmetric", False)))
    real = scene["pair_idx"][:, 0] < scene["pair_idx"][:, 1]
    real_pairs = scene["pair_idx"][real].long()
    rj, rv, substitute = (ref or matcher).reference_matches(out, real_pairs, spec,
                                                            control.get("matcher"))
    pm, pv = substitute or (scene["match_ij"][real].long(), scene["valid_ij"][real].bool())
    nums.update(judge_matches(scene["keypoints"], real_pairs, pm, pv, rj, rv, truth["poses"],
                              truth["intr"], spec["min_matches"], spec["consistent_px"],
                              spec["epi_px"]))
    nums.update(judge_map(scene, control.get("poses"), control.get("points")))
    return nums


def worst_readings(outs, truth: dict, spec: dict, rng: np.random.Generator,
                   control: dict | None = None) -> dict:
    """The largest reading of each number over the requests ``outs``."""
    worst = {}
    for out in outs:
        for k, v in judge_request(out, truth, spec, rng, control).items():
            worst[k] = max(worst.get(k, -float("inf")), v)
    return worst
