"""Incremental SfM driver (port of eacham_tpu/sfm/pipeline.py), front half.

``initialize_sfm`` takes features to the seeded two-view map: the match
graph with epipolar verification (built here over all pairs or a windowed
candidate subset, or handed in as ``match_tables`` by another matcher such
as the deep frontend), the init-pair ranking and search, and the seeding
of the map. It is exactly what the reference's ``run_sfm`` does before its
registration sweep, on a single device. PnP registration, the sweep and
bundle adjustment come with the next slices of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.geometry.camera import intrinsics_from_image_size
from eacham_tpu_torch.sfm.matches import (
    all_pairs_index, build_match_tables, candidate_pairs, invert_matches,
    verify_matches_epipolar,
)
from eacham_tpu_torch.sfm.scene import Scene, alloc_landmarks, make_scene
from eacham_tpu_torch.sfm.twoview import find_best_pair


@dataclass(frozen=True)
class SfmOptions:
    """Run configuration; the same fields and defaults as the reference's
    ``SfmOptions`` (eacham_tpu/sfm/pipeline.py), so a configuration moves
    between the two packages unchanged. Fields past the two-view
    initialization are carried for the later slices."""

    # features / matching
    max_features: int = 1024
    min_features_count: int = 0
    match_ratio: float = 0.8
    min_matches: int = 30
    # initial pair
    min_initial_inliers: int = 450
    init_max_repr_error: float = 4.0
    init_min_tri_angle_deg: float = 3.0
    # incremental processing
    max_repr_error: float = 8.0
    min_tri_angle_deg: float = 2.0
    min_pnp_inliers: int = 15
    # bundle adjustment budgets
    refine_max_iters: int = 100
    refine_tolerance: float = 1e-5
    refine_method: str = "LM"
    refine_delta: float = 10.0
    global_method: str = "LM"
    global_delta: float = 10.0
    refine_solver: str = "auto"
    global_solver: str = "auto"
    local_ba_max_iters: int = 5
    local_ba_tolerance: float = 3e-4
    local_ba_max_cams: int = 16
    local_ba_max_obs: int = 16384
    local_ba_max_lms: int = 8192
    local_ba_every: int = 1
    global_max_iters: int = 150
    global_tolerance: float = 1e-7
    min_ba_landmarks: int = 50
    # shape budgets
    max_observers: int = 12
    lm_capacity: int | None = None
    ransac_hyps_e: int = 512
    ransac_hyps_h: int = 256
    ransac_hyps_pnp: int = 512
    init_chunk: int = 8
    match_chunk: int = 16
    # candidate-pair selection: 0 = exhaustive enumeration
    pair_window: int = 0
    pair_retrieval_k: int = 5
    pair_ladder: bool = True
    n_devices: int = 1
    abs_sigma_rot: float = 0.01
    abs_sigma_pos: float = 0.01
    checkpoint_path: str | None = None
    checkpoint_every: int = 1
    # behavior switches
    pnp_pair_only: bool = False
    run_global_ba: bool = True
    device_loop: bool = True
    sweep_segment: int = 128
    interim_ba_iters: int = 10
    # per-pair essential-matrix verification of the match graph (RANSAC
    # hypotheses per pair; 0 = off)
    verify_hyps: int = 64
    loop_close: bool = True
    pgo_iters: int = 12
    pgo_min_consistency_deg: float = 8.0
    submap_align_min_deg: float = 15.0
    submap_size: int = 50
    local_ba_free_span: int = 0
    ba_program_iters: int = 10
    prune_outliers: bool = True
    map_refine_rounds: int = -1
    seed: int = 0

    @property
    def init_min_tri_angle(self) -> float:
        return float(np.deg2rad(self.init_min_tri_angle_deg))

    @property
    def min_tri_angle(self) -> float:
        return float(np.deg2rad(self.min_tri_angle_deg))


def rank_init_pairs(scene: Scene, max_dim: float) -> torch.Tensor:
    """Init-pair candidate score [P]: match count weighted by the spread of
    the flow field around its mean (a baseline proxy: a rotating camera
    gives large uniform flow at zero baseline); -1 for dead edges."""
    i = scene.pair_idx[:, 0].long()
    j = scene.pair_idx[:, 1].long()
    uv_i = scene.keypoints[i]                                # [P, K, 2]
    uv_j = torch.gather(scene.keypoints[j], 1,
                        scene.match_ij.long()[..., None].expand(-1, -1, 2))
    flow = uv_j - uv_i
    v = scene.valid_ij
    n = v.sum(1)
    n1 = torch.clamp(n, min=1)
    mean_flow = torch.where(v[..., None], flow, 0.0).sum(1) / n1[:, None]
    dev = torch.linalg.vector_norm(flow - mean_flow[:, None, :], dim=-1)
    spread = torch.where(v, dev, 0.0).sum(1) / n1
    weight = torch.clamp(spread / torch.full_like(spread, 0.03 * max_dim), max=1.0)
    return torch.where(scene.pair_ok, n * weight, -1.0)


def seed_initial_pair(scene: Scene, pair_row: int, T2, points, point_ok) -> Scene:
    """Fix frame i at identity, set frame j's pose, seed the map with the
    two-view points and link both frames' keypoints to them."""
    i, j = (int(x) for x in scene.pair_idx[pair_row].tolist())
    K = scene.kp_mask.shape[1]
    pose = scene.pose.clone()
    pose[i] = torch.eye(4, dtype=pose.dtype, device=pose.device)
    pose[j] = T2
    pose_valid = scene.pose_valid.clone()
    pose_valid[[i, j]] = True
    pose_fixed = scene.pose_fixed.clone()
    pose_fixed[i] = True
    scene = scene._replace(pose=pose, pose_valid=pose_valid, pose_fixed=pose_fixed)
    scene, ids = alloc_landmarks(scene, points, point_ok)
    got = ids >= 0
    lm_two_view = scene.lm_two_view.clone()
    lm_two_view[ids[got].long()] = True
    kp2lm = scene.kp2lm.clone()
    kk = torch.arange(K, device=ids.device)
    kp2lm[i, kk[got]] = ids[got]
    kp2lm[j, scene.match_ij[pair_row].long()[got]] = ids[got]
    return scene._replace(lm_two_view=lm_two_view, kp2lm=kp2lm)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def initialize_sfm(
    keypoints,                 # [N, K, 2]
    descriptors,               # [N, K, D] L2-normalized
    kp_mask,                   # [N, K]
    image_size: tuple[int, int],   # (width, height)
    intr=None,
    options: SfmOptions = SfmOptions(),
    generator: torch.Generator | None = None,
    device: str | torch.device | None = "cuda",
    match_tables: tuple | None = None,
    verbose: bool = False,
):
    """Features -> verified match graph -> init pair -> seeded map.

    Returns ``(scene, stats)``. ``stats`` holds the surviving edges, the
    init pair ``(i0, j0)`` with its ``n_good`` and ``used_homography``
    (``initialized`` False and the pair None when no pair passes), and the
    wall seconds of each stage. ``generator`` drives every RANSAC draw; by
    default it is seeded from ``options.seed``.

    By default pairs are matched with the fused descriptor matcher, over
    all pairs or, with ``options.pair_window > 0``, over the windowed
    candidate subset. ``match_tables`` plugs in another matcher: either the
    6-tuple of ``features.deep.frontend.build_match_tables_deep``
    (``pair_idx, pair_ok, match_ij, valid_ij, match_ji, valid_ji``, taken
    as is: already verified), or ``(match_ij [P, K], valid_ij [P, K],
    pair_ok [P])`` over all pairs in canonical i < j order, which gets the
    same epipolar cleanup as the built-in matcher's tables.
    """
    opt = options
    if opt.n_devices > 1:
        raise NotImplementedError("initialize_sfm runs on one device")
    if match_tables is not None and len(match_tables) not in (3, 6):
        raise ValueError("match_tables is a 3-tuple or a 6-tuple; got "
                         f"{len(match_tables)} entries")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(opt.seed)
    keypoints = as_tensor(keypoints, dev, torch.float32)
    descriptors = as_tensor(descriptors, dev, torch.float32)
    kp_mask = as_tensor(kp_mask, dev, torch.bool)
    N = keypoints.shape[0]
    intr = (intrinsics_from_image_size(*image_size, device=dev) if intr is None
            else as_tensor(intr, dev, torch.float32))
    seconds = {}
    t0 = time.perf_counter()

    def log(*a):
        if verbose:
            print(f"[sfm +{time.perf_counter() - t0:7.2f}s]", *a, flush=True)

    if opt.min_features_count > 0:
        enough = kp_mask.sum(1) >= opt.min_features_count
        kp_mask = kp_mask & enough[:, None]

    # ---- match graph ------------------------------------------------------
    t = time.perf_counter()
    if match_tables is None:
        cand = None
        if opt.pair_window > 0:
            cand = candidate_pairs(descriptors, kp_mask, window=opt.pair_window,
                                   retrieval_k=opt.pair_retrieval_k, ladder=opt.pair_ladder)
            log(f"candidate pairs: {cand.shape[0]} of {N * (N - 1) // 2}")
        verify = None
        if opt.verify_hyps > 0:
            verify = (keypoints, intr, generator, opt.max_repr_error, opt.verify_hyps)
        pair_idx, pair_ok, m_ij, v_ij, m_ji, v_ji = build_match_tables(
            descriptors, kp_mask, ratio=opt.match_ratio, min_matches=opt.min_matches,
            chunk=opt.match_chunk, verify=verify, pair_idx=cand)
    elif len(match_tables) == 6:
        pair_idx, pair_ok, m_ij, v_ij, m_ji, v_ji = (
            as_tensor(x, dev) for x in match_tables)
    else:
        m_ij, v_ij, pair_ok = (as_tensor(x, dev) for x in match_tables)
        pair_idx = torch.as_tensor(all_pairs_index(N), device=dev)
        if opt.verify_hyps > 0:
            v_ij = verify_matches_epipolar(
                keypoints, pair_idx, m_ij, v_ij, intr, generator,
                px_threshold=opt.max_repr_error, n_hyp=opt.verify_hyps)
            pair_ok = pair_ok & (v_ij.sum(-1) > opt.min_matches)
        v_ij = v_ij & pair_ok[:, None]
        m_ji, v_ji = invert_matches(m_ij, v_ij)
    _sync(dev)
    seconds["match_graph"] = time.perf_counter() - t
    del descriptors
    scene = make_scene(keypoints, kp_mask, pair_idx, pair_ok, m_ij, v_ij,
                       m_ji, v_ji, intr, lm_capacity=opt.lm_capacity)
    n_edges = int(pair_ok.sum())
    log(f"match graph: {n_edges}/{pair_idx.shape[0]} edges survive")
    stats = {"frames": N, "pairs": int(pair_idx.shape[0]), "edges": n_edges,
             "initialized": False, "init_pair": None, "pair_row": None,
             "n_good": 0, "used_homography": False, "seconds": seconds}

    # ---- initial pair -------------------------------------------------------
    t = time.perf_counter()
    score = rank_init_pairs(scene, float(max(image_size))).cpu().numpy()
    order = np.argsort(-score)
    order = order[score[order] > 0]
    pair_row, init = find_best_pair(
        generator, scene, order,
        min_initial_inliers=opt.min_initial_inliers,
        max_repr_error=opt.init_max_repr_error,
        min_tri_angle=opt.init_min_tri_angle,
        chunk=opt.init_chunk, n_hyp_e=opt.ransac_hyps_e, n_hyp_h=opt.ransac_hyps_h)
    seconds["init_pair"] = time.perf_counter() - t
    if pair_row is None:
        log("no initial pair found")
        return scene, stats
    i0, j0 = (int(x) for x in scene.pair_idx[pair_row].tolist())
    t = time.perf_counter()
    scene = seed_initial_pair(scene, pair_row, init.T, init.points, init.point_ok)
    _sync(dev)
    seconds["seed"] = time.perf_counter() - t
    stats.update(initialized=True, init_pair=(i0, j0), pair_row=pair_row,
                 n_good=int(init.n_good), used_homography=bool(init.used_homography),
                 T_init=init.T)
    log(f"init pair ({i0}, {j0}): {stats['n_good']} points, "
        f"H={stats['used_homography']}")
    return scene, stats
