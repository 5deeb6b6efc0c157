"""Incremental SfM (port of eacham_tpu/sfm/pipeline.py): the whole
reconstruction loop on one device.

``run_sfm`` is extract's consumer: match graph -> init pair -> {next-best
view, PnP, triangulate(2), windowed local BA, triangulate(3)} loop ->
prune, global BA, prune. ``initialize_sfm`` is its front half, up to the
seeded two-view map: the match graph with epipolar verification (built here
over all pairs or a windowed candidate subset, or handed in as
``match_tables`` by another matcher such as the deep frontend), the
init-pair ranking and search, and the seeding of the map.

Deviations from the C++ ancestor that the reference made and the port
keeps: PnP gathers 3D-2D correspondences from all registered neighbours of
the new frame, not only the selected edge (``pnp_pair_only=True`` for the
old behaviour); next-best-view ties break by match count.

Not carried yet, and refused with ``NotImplementedError``: sharding over
several devices, checkpoints, and the loop-closing / map-rebuild stage of
windowed runs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from eacham_tpu_torch.ba.core import BAConfig, refine_ba
from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.geometry.camera import intrinsics_from_image_size
from eacham_tpu_torch.geometry.pnp import solve_pnp_ransac
from eacham_tpu_torch.sfm.filtering import prune_observations
from eacham_tpu_torch.sfm.matches import (
    all_pairs_index, build_match_tables, candidate_pairs, invert_matches,
    observers_of_frame, verify_matches_epipolar,
)
from eacham_tpu_torch.sfm.scene import (
    Scene, alloc_landmarks, ba_problem_counts, ba_problem_windowed,
    frame_pair_table, make_scene, scatter_window_points, scatter_window_poses,
)
from eacham_tpu_torch.sfm.triangulate import first_true, triangulate_frame
from eacham_tpu_torch.sfm.twoview import find_best_pair


@dataclass(frozen=True)
class SfmOptions:
    """Run configuration; the same fields and defaults as the reference's
    ``SfmOptions`` (eacham_tpu/sfm/pipeline.py), so a configuration moves
    between the two packages unchanged. ``device_loop`` picks between the
    segmented sweep of ``sfm/device_loop.py`` (with interim global BA
    between segments) and the plain per-frame loop; both run on the host
    here. ``n_devices > 1`` and ``checkpoint_path`` are refused."""

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


@torch.no_grad()
def next_best_view(scene: Scene, excluded: torch.Tensor):
    """Pick the (registered, unregistered) edge with the most non-two-view
    landmarks on the registered side that match into the candidate,
    tie-broken by match count, then by the first in (forward rows, backward
    rows) order. Returns 0-d tensors (prev, cur, score), score < 0 when no
    candidate edge exists."""
    K = scene.kp_mask.shape[1]
    lm = scene.kp2lm
    lm_safe = torch.clamp(lm, min=0).long()
    kp_good = (lm >= 0) & scene.lm_valid[lm_safe] & (~scene.lm_two_view[lm_safe])
    i = scene.pair_idx[:, 0].long()
    j = scene.pair_idx[:, 1].long()
    n_matches = scene.valid_ij.sum(1)

    def side(a, b, valid_ab, kp_a):
        score = (valid_ab & kp_a).sum(1)
        gate = scene.pair_ok & scene.pose_valid[a] & (~scene.pose_valid[b]) & (~excluded[b])
        return torch.where(gate, score * (K + 1) + n_matches, -1)

    s = torch.cat([side(i, j, scene.valid_ij, kp_good[i]),
                   side(j, i, scene.valid_ji, kp_good[j])])
    # the first maximum: the largest of s * 2P + (2P - 1 - slot)
    P2 = s.shape[0]
    slot = torch.arange(P2, device=s.device)
    best = P2 - 1 - (s * P2 + (P2 - 1 - slot)).amax() % P2
    P = i.shape[0]
    fwd = best < P
    row = torch.where(fwd, best, best - P)
    prev = torch.where(fwd, i[row], j[row])
    cur = torch.where(fwd, j[row], i[row])
    return prev, cur, s[best]


@torch.no_grad()
def pnp_register(scene: Scene, prev, cur, pair_rows: torch.Tensor,
                 generator: torch.Generator | None = None, threshold: float = 4.0,
                 n_hyp: int = 512, pair_only: bool = False, sample_idx=None):
    """Gather 3D-2D correspondences for the new frame ``cur`` (an int, as
    ``prev``) from its registered neighbours ``pair_rows`` = frame_pair_table[cur] and solve
    PnP. Returns (T [4, 4], n_inliers); the caller applies the min-inlier
    gate."""
    K = scene.kp_mask.shape[1]
    obs_frame, obs_kp, obs_on = observers_of_frame(
        cur, pair_rows, scene.pair_idx, scene.pair_ok,
        scene.match_ij, scene.valid_ij, scene.match_ji, scene.valid_ji)   # [D], [D, K]
    obs_on = obs_on & scene.pose_valid[obs_frame][:, None] & scene.kp_mask[cur][None, :]
    if pair_only:
        obs_on = obs_on & (obs_frame[:, None] == prev)
    nb_lm = scene.kp2lm[obs_frame[:, None], obs_kp].long()
    has = obs_on & (nb_lm >= 0) & scene.lm_valid[torch.clamp(nb_lm, min=0)]
    src, ok = first_true(has, 0)              # first neighbour with a landmark
    lm_id = torch.clamp(nb_lm, min=0)[src, torch.arange(K, device=src.device)]
    T, _, n_inl = solve_pnp_ransac(
        scene.points[lm_id], scene.keypoints[cur], ok, scene.intr, threshold=threshold,
        n_hyp=n_hyp, generator=generator, sample_idx=sample_idx)
    return T, n_inl


def _bucket(n: int, cap: int, floor: int = 1024) -> int:
    """Smallest size of the form 2^k or 3 * 2^k that fits ``n`` (capped):
    the reference's bucketing of the compact BA axes, kept so that both
    packages build the same problem shapes."""
    if n >= cap:
        return cap
    b = floor
    while b < n:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return min(b, cap)


def _ba(scene: Scene, cam_in_ba, cfg: BAConfig, min_landmarks: int,
        program_iters: int = 0, abs_anchors=None):
    """Build the BA problem over ``cam_in_ba`` with its axes compacted to
    bucketed sizes (two scalars are read back to choose them), skip it if
    it holds fewer than ``min_landmarks`` landmarks, run LM, write back.
    Returns (scene, info or None).

    ``abs_anchors = (poses [N, 4, 4], mask [N])`` adds absolute pose
    references; they fix the gauge, so the init-pair freeze is released.
    ``program_iters > 0`` splits the LM budget of a large problem (more
    than 131072 observation slots) into rounds of that many iterations,
    stopping early when a round's relative cost decrease falls under the
    tolerance.
    """
    N, K = scene.kp_mask.shape
    n_obs, n_lms = torch.stack(ba_problem_counts(scene, cam_in_ba)).tolist()
    if n_lms < min_landmarks:
        return scene, None
    prob, cam_list, cam_on, lm_list, lm_on = ba_problem_windowed(
        scene, cam_in_ba, max_cams=N, max_obs=_bucket(n_obs, N * K),
        max_lms=_bucket(n_lms, scene.lm_capacity))
    if abs_anchors is not None:
        a_pose, a_mask = (as_tensor(x, cam_list.device) for x in abs_anchors)
        prob = prob._replace(abs_pose=a_pose.to(prob.poses.dtype)[cam_list],
                             abs_mask=a_mask.bool()[cam_list] & cam_on,
                             cam_fixed=torch.zeros_like(prob.cam_fixed))
    rounds, run_cfg = 1, cfg
    if program_iters > 0 and cfg.max_iters > program_iters and prob.obs_cam.shape[0] > 131072:
        rounds = -(-cfg.max_iters // program_iters)
        run_cfg = cfg._replace(max_iters=program_iters)
    info = None
    for _ in range(rounds):
        poses, points, intr, info_r = refine_ba(prob, run_cfg)
        if info is None:
            info = dict(info_r)
        else:
            info["final_cost"] = info_r["final_cost"]
            info["iterations"] += info_r["iterations"]
        prob = prob._replace(poses=poses, points=points, intr=intr)
        if rounds > 1:
            c0, c1 = float(info_r["initial_cost"]), float(info_r["final_cost"])
            if abs(c0 - c1) / max(c0, 1e-9) < cfg.tolerance:
                break
    scene = scatter_window_poses(scene, cam_list, cam_on, poses)
    scene = scatter_window_points(scene, lm_list, lm_on, points)
    return scene._replace(intr=intr), info


def set_pose(scene: Scene, frame: int, T: torch.Tensor) -> Scene:
    """The scene with ``frame`` registered at pose ``T``."""
    pose = scene.pose.clone()
    pose[frame] = T
    pose_valid = scene.pose_valid.clone()
    pose_valid[frame] = True
    return scene._replace(pose=pose, pose_valid=pose_valid)


@torch.no_grad()
def local_neighbors(scene: Scene, cur: int) -> torch.Tensor:
    """[N] bool: the frames of a local BA, the new frame ``cur`` and its
    registered edge-neighbours."""
    i = scene.pair_idx[:, 0].long()
    j = scene.pair_idx[:, 1].long()
    N = scene.kp_mask.shape[0]
    on_i = scene.pair_ok & (j == cur)
    on_j = scene.pair_ok & (i == cur)
    nb = torch.zeros(N, dtype=torch.int32, device=i.device)
    nb.index_add_(0, i, on_i.to(torch.int32)).index_add_(0, j, on_j.to(torch.int32))
    return ((nb > 0) & scene.pose_valid) | (torch.arange(N, device=i.device) == cur)


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
        raise NotImplementedError(
            "n_devices > 1: sharding over several devices is not ported yet "
            "(ROADMAP queue 1, item 14: parallel/)")
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


def _ba_configs(opt: SfmOptions):
    """(local refine config, global config) of a run."""
    refine_cfg = BAConfig(
        max_iters=min(opt.refine_max_iters, opt.local_ba_max_iters),
        tolerance=max(opt.refine_tolerance, opt.local_ba_tolerance),
        method=opt.refine_method.lower(), trust_radius_init=opt.refine_delta,
        solver=opt.refine_solver)
    global_cfg = BAConfig(
        max_iters=opt.global_max_iters, tolerance=opt.global_tolerance,
        method=opt.global_method.lower(), trust_radius_init=opt.global_delta,
        solver=opt.global_solver, abs_sigma_rot=opt.abs_sigma_rot,
        abs_sigma_pos=opt.abs_sigma_pos)
    return refine_cfg, global_cfg


def _refuse_unported(opt: SfmOptions, n_far: int = 0) -> None:
    """Raise for what a run with these options and ``n_far`` long-range
    edges would enter and this port does not carry yet."""
    if opt.n_devices > 1:
        raise NotImplementedError(
            "n_devices > 1: sharding over several devices is not ported yet "
            "(ROADMAP queue 1, item 14: parallel/)")
    if opt.checkpoint_path:
        raise NotImplementedError(
            "checkpoint_path: scene checkpoints are not ported yet "
            "(ROADMAP queue 1, item 10: io/)")
    globally = opt.run_global_ba and opt.global_max_iters > 0
    windowed_far = opt.pair_window > 0 and n_far > 0
    if windowed_far and opt.device_loop and opt.loop_close:
        raise NotImplementedError(
            f"loop_close with pair_window > 0 and {n_far} long-range edges: the "
            "pose-graph stage is not ported yet (ROADMAP queue 1, item 12: "
            "sfm/posegraph.py, submap.py); pass loop_close=False")
    if globally and (opt.map_refine_rounds > 0
                     or (opt.map_refine_rounds < 0 and windowed_far)):
        raise NotImplementedError(
            f"map_refine_rounds={opt.map_refine_rounds} (pair_window {opt.pair_window}, "
            f"{n_far} long-range edges): rebuild_map is not ported yet (ROADMAP queue 1, "
            "item 12: sfm/posegraph.py); pass map_refine_rounds=0")


@torch.no_grad()
def run_sfm(
    keypoints,                 # [N, K, 2]
    descriptors,               # [N, K, D] L2-normalized
    kp_mask,                   # [N, K]
    image_size: tuple[int, int],   # (width, height)
    intr=None,
    options: SfmOptions = SfmOptions(),
    verbose: bool = False,
    match_tables: tuple | None = None,
    abs_anchors: tuple | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = "cuda",
):
    """Full incremental reconstruction. Returns ``(scene, stats)``.

    ``initialize_sfm`` takes the features to the seeded two-view map (see
    there for ``match_tables``); then the registration sweep takes every
    reachable frame into the map, and ``_finalize`` prunes, runs the global
    BA and prunes again. ``abs_anchors = (poses [N, 4, 4] world->cam, mask
    [N])`` are optional absolute pose references in the reconstruction's
    frame, used as tight priors by every global BA.

    ``stats``: what ``initialize_sfm`` reports, plus ``registered``,
    ``excluded``, ``landmarks``, the global BA's ``global_ba`` (iterations,
    initial and final cost; None when it did not run), and the wall
    seconds of ``sweep`` and ``finalize`` beside the earlier stages'.
    """
    opt = options
    _refuse_unported(opt)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(opt.seed)
    t0 = time.perf_counter()

    def log(*a):
        if verbose:
            print(f"[sfm +{time.perf_counter() - t0:7.2f}s]", *a, flush=True)

    scene, stats = initialize_sfm(
        keypoints, descriptors, kp_mask, image_size, intr=intr, options=opt,
        generator=generator, device=dev, match_tables=match_tables, verbose=verbose)
    N, K = scene.kp_mask.shape
    stats.update(registered=0, excluded=0, landmarks=0, global_ba=None)
    if not stats["initialized"]:
        return scene, stats

    pi_np = scene.pair_idx.cpu().numpy()
    span = np.abs(pi_np[:, 1].astype(np.int64) - pi_np[:, 0])
    n_far = int((scene.pair_ok.cpu().numpy() & (span > max(N // 4, 30))).sum())
    _refuse_unported(opt, n_far)
    fp_tbl = torch.as_tensor(frame_pair_table(pi_np, N), device=dev)
    refine_cfg, global_cfg = _ba_configs(opt)

    # ---- incremental loop -----------------------------------------------------
    t = time.perf_counter()
    excluded = torch.zeros(N, dtype=torch.bool, device=dev)
    if opt.device_loop:
        from eacham_tpu_torch.sfm.device_loop import registration_sweep

        on_segment = None
        if opt.interim_ba_iters > 0:
            interim_cfg = global_cfg._replace(max_iters=opt.interim_ba_iters)

            def on_segment(s):
                s, info = _ba(s, s.pose_valid, interim_cfg, opt.min_ba_landmarks,
                              program_iters=opt.ba_program_iters)
                if info is not None:
                    log(f"interim BA: {float(info['initial_cost']):.1f} -> "
                        f"{float(info['final_cost']):.1f}")
                return s

        scene, excluded, n_reg = registration_sweep(
            scene, excluded, fp_tbl, generator, opt.max_repr_error, opt.min_tri_angle,
            min_pnp_inliers=opt.min_pnp_inliers, min_ba_landmarks=opt.min_ba_landmarks,
            ba_cfg=refine_cfg, max_observers=opt.max_observers,
            n_hyp_pnp=opt.ransac_hyps_pnp, pnp_pair_only=opt.pnp_pair_only,
            ba_max_cams=opt.local_ba_max_cams,
            # a window of C cameras holds at most C * K observations
            ba_max_obs=min(opt.local_ba_max_obs, min(opt.local_ba_max_cams, N) * K),
            ba_max_lms=opt.local_ba_max_lms, ba_every=opt.local_ba_every,
            ba_free_span=opt.local_ba_free_span, segment=opt.sweep_segment,
            on_segment=on_segment)
        log(f"sweep: +{n_reg} frames registered, {int(excluded.sum())} excluded")
    else:
        scene, excluded = _host_loop(scene, excluded, fp_tbl, generator, opt, refine_cfg, log)
    _sync(dev)
    stats["seconds"]["sweep"] = time.perf_counter() - t

    t = time.perf_counter()
    scene, final = _finalize(scene, excluded, opt, global_cfg, log, abs_anchors=abs_anchors)
    _sync(dev)
    stats["seconds"]["finalize"] = time.perf_counter() - t
    stats.update(final)
    log(f"done: {stats['registered']}/{N} frames registered, {stats['landmarks']} landmarks")
    return scene, stats


def _host_loop(scene, excluded, fp_tbl, generator, opt: SfmOptions, refine_cfg, log):
    """The plain per-frame loop (``device_loop=False``): a local BA over all
    registered neighbours at every registration, no segments, no interim
    BA. Returns (scene, excluded)."""
    N = scene.kp_mask.shape[0]
    for _ in range(N):
        prev, cur, score = (int(v) for v in torch.stack(next_best_view(scene, excluded)).tolist())
        if score < 0:
            break
        T, n_inl = pnp_register(scene, prev, cur, fp_tbl[cur], generator, threshold=4.0,
                                n_hyp=opt.ransac_hyps_pnp, pair_only=opt.pnp_pair_only)
        n_inl = int(n_inl)
        if n_inl < opt.min_pnp_inliers:
            log(f"frame {cur}: PnP failed ({n_inl} inliers), excluded")
            excluded = excluded.clone()
            excluded[cur] = True
            continue
        scene = set_pose(scene, cur, T)
        scene, n_merged, n_new = triangulate_frame(
            scene, cur, fp_tbl[cur], 2, opt.max_repr_error, opt.min_tri_angle,
            max_observers=opt.max_observers)
        scene, info = _ba(scene, local_neighbors(scene, cur), refine_cfg, opt.min_ba_landmarks)
        scene, n_merged3, n_new3 = triangulate_frame(
            scene, cur, fp_tbl[cur], 3, opt.max_repr_error, opt.min_tri_angle,
            max_observers=opt.max_observers)
        if info is not None:
            ba_txt = f", BA {float(info['initial_cost']):.1f}->{float(info['final_cost']):.1f}"
        else:
            ba_txt = ""
        log(f"frame {cur} <- {prev}: PnP {n_inl} inl, tri +{int(n_new) + int(n_new3)} lm "
            f"(merged {int(n_merged) + int(n_merged3)}){ba_txt}")
    return scene, excluded


def _finalize(scene: Scene, excluded, opt: SfmOptions, global_cfg: BAConfig, log,
              abs_anchors=None):
    """Prune, global BA, prune, and a second BA when the second prune
    changed the problem (at least 0.1% of the observations, and 8, removed).
    Returns (scene, run statistics)."""
    ba_info = None
    if opt.run_global_ba and opt.global_max_iters > 0:
        if opt.prune_outliers:
            scene, n_obs, n_lm = prune_observations(scene, opt.max_repr_error)
            log(f"prune: -{int(n_obs)} observations, -{int(n_lm)} landmarks")
        scene, info = _ba(scene, scene.pose_valid, global_cfg, opt.min_ba_landmarks,
                          program_iters=opt.ba_program_iters, abs_anchors=abs_anchors)
        if info is not None:
            ba_info = {"iterations": info["iterations"],
                       "initial_cost": float(info["initial_cost"]),
                       "final_cost": float(info["final_cost"]), "second": None}
            log(f"global BA: {ba_info['initial_cost']:.1f} -> {ba_info['final_cost']:.1f} "
                f"({ba_info['iterations']} iters)")
        if opt.prune_outliers and info is not None:
            scene, n_obs, n_lm = prune_observations(scene, opt.max_repr_error)
            n_obs = int(n_obs)
            total_obs = int(((scene.kp2lm >= 0) & scene.kp_mask
                             & scene.pose_valid[:, None]).sum())
            if n_obs >= max(8, total_obs // 1000):
                scene, info2 = _ba(scene, scene.pose_valid, global_cfg, opt.min_ba_landmarks,
                                   program_iters=opt.ba_program_iters,
                                   abs_anchors=abs_anchors)
                if info2 is not None:
                    ba_info["second"] = {"iterations": info2["iterations"],
                                         "initial_cost": float(info2["initial_cost"]),
                                         "final_cost": float(info2["final_cost"])}
                    log(f"global BA 2 (post-prune -{n_obs} obs): "
                        f"{ba_info['second']['initial_cost']:.1f} -> "
                        f"{ba_info['second']['final_cost']:.1f}")
            else:
                log(f"global BA 2 skipped (prune removed {n_obs} obs of {total_obs})")
    return scene, {"registered": int(scene.pose_valid.sum()),
                   "excluded": int(excluded.sum()),
                   "landmarks": int(scene.lm_valid.sum()), "global_ba": ba_info}
