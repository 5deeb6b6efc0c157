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

Long trajectories (``pair_window > 0`` with long-range edges surviving):
after the sweep, the loop-closing stage measures every long-range edge by
PnP, gates on the loop consistency, and may align rigid submaps and solve
the pose graph before rebuilding the map (``sfm/posegraph.py``,
``sfm/submap.py``); the finalization then runs map-refinement rounds
(rebuild, prune, global BA). ``abs_anchors`` (``sfm/anchors.py``) add
absolute pose priors to every global BA.

``resume_sfm`` continues a (checkpointed) scene: the registration sweep
over the frames still unregistered, then the finalization. With
``checkpoint_path`` set, both sweeps save the scene after every
``checkpoint_every``-th segment (``io/checkpoint.py``).

Several devices (``n_devices > 1``): one process per device, launched
together (``torchrun --nproc-per-node N``), each calling
``parallel.init_distributed()`` first. Every rank runs the same pipeline;
the match graph's pairs and the global BAs' observations are split over
the ranks (``parallel/``). The other stages run on every rank, and rank
0's state and decisions hold at every point where the ranks meet
(``sync_ranks``): the features, the verified graph, the initial pair,
each sweep segment, each sharded BA. The reference's ``EACHAM_PGO_DUMP`` debug dump of the pose-graph
inputs is not read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from eacham_tpu_torch.ba.core import BAConfig
from eacham_tpu_torch.device import as_tensor, resolve_device, to_numpy
from eacham_tpu_torch.geometry.camera import intrinsics_from_image_size
from eacham_tpu_torch.geometry.pnp import solve_pnp_ransac
from eacham_tpu_torch.parallel.ba import broadcast_state, refine_ba_sharded
from eacham_tpu_torch.parallel.mesh import local_mesh, make_mesh
from eacham_tpu_torch.sfm.filtering import prune_observations
from eacham_tpu_torch.sfm.matches import (
    all_pairs_index, build_match_tables, candidate_pairs, invert_matches,
    observers_of_frame, verify_matches_epipolar,
)
from eacham_tpu_torch.sfm.posegraph import (
    edge_measurements, loop_consistency, loop_pnp_measurements, optimize_pose_graph,
    rebuild_map,
)
from eacham_tpu_torch.sfm.scene import (
    Scene, alloc_landmarks, ba_problem_counts, ba_problem_windowed, frame_pair_table,
    frame_row, make_scene, scatter_window_points, scatter_window_poses,
)
from eacham_tpu_torch.sfm.submap import submap_align
from eacham_tpu_torch.sfm.triangulate import first_true, triangulate_frame
from eacham_tpu_torch.sfm.twoview import find_best_pair
from eacham_tpu_torch.utils import timer


@dataclass(frozen=True)
class SfmOptions:
    """Run configuration; the same fields and defaults as the reference's
    ``SfmOptions`` (eacham_tpu/sfm/pipeline.py), so a configuration moves
    between the two packages unchanged. ``device_loop`` picks between the
    segmented sweep of ``sfm/device_loop.py`` (with interim global BA
    between segments) and the plain per-frame loop; both run on the host
    here. ``n_devices > 1`` needs a process group of that many ranks (see
    the module docstring)."""

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
    # an index that is a 0-d device tensor is read to the host: five waits
    timer.add("readbacks", 5)
    prev = torch.where(fwd, i[row], j[row])
    cur = torch.where(fwd, j[row], i[row])
    return prev, cur, s[best]


@torch.no_grad()
def pnp_register(scene: Scene, prev, cur, pair_rows: torch.Tensor,
                 generator: torch.Generator | None = None, threshold: float = 4.0,
                 n_hyp: int = 512, pair_only: bool = False, sample_idx=None,
                 uniforms=None):
    """Gather 3D-2D correspondences for the new frame ``cur`` (an int, or a
    one-element index tensor on the scene's device; as ``prev``) from its
    registered neighbours ``pair_rows`` = frame_pair_table[cur] and solve
    PnP. Returns (T [4, 4], n_inliers); the caller applies the min-inlier
    gate. ``uniforms``: the RANSAC sampler's draw made by the caller
    (``ransac.draw_uniforms``: [n_hyp, K]) in place of one from
    ``generator``."""
    K = scene.kp_mask.shape[1]
    obs_frame, obs_kp, obs_on = observers_of_frame(
        cur, pair_rows, scene.pair_idx, scene.pair_ok,
        scene.match_ij, scene.valid_ij, scene.match_ji, scene.valid_ji)   # [D], [D, K]
    obs_on = obs_on & scene.pose_valid[obs_frame][:, None] & frame_row(scene.kp_mask, cur)[None, :]
    if pair_only:
        obs_on = obs_on & (obs_frame[:, None] == prev)
    nb_lm = scene.kp2lm[obs_frame[:, None], obs_kp].long()
    has = obs_on & (nb_lm >= 0) & scene.lm_valid[torch.clamp(nb_lm, min=0)]
    src, ok = first_true(has, 0)              # first neighbour with a landmark
    lm_id = torch.clamp(nb_lm, min=0)[src, torch.arange(K, device=src.device)]
    T, _, n_inl = solve_pnp_ransac(
        scene.points[lm_id], frame_row(scene.keypoints, cur), ok, scene.intr,
        threshold=threshold, n_hyp=n_hyp, generator=generator, sample_idx=sample_idx,
        uniforms=uniforms)
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


_SCENE_STATE = ("pose", "pose_valid", "pose_fixed", "points", "lm_valid", "lm_two_view",
                "n_landmarks", "kp2lm", "intr")


def sync_ranks(mesh, scene: Scene, excluded=None, *flags, fields=_SCENE_STATE):
    """Rank 0's ``fields`` of ``scene``, its ``excluded`` and its integer
    ``flags`` on every rank of ``mesh``. Without a process group nothing
    moves and nothing is read from the device. Returns (scene, excluded,
    [flags]).

    Each rank runs the replicated stages (the epipolar verification, the
    initial pair, the sweep) on its own. One card gives one result per
    input, but nothing holds cards of other models (their libraries pick
    other kernels) to the same bits, so the ranks' results may part. So
    every decision that leads to a collective
    is taken on rank 0's values: all ranks run the same collectives in the
    same order, and rank 0's state holds from there on.
    """
    if mesh is None or mesh.group is None:
        return scene, excluded, list(flags)
    extra = [] if excluded is None else [excluded]
    if flags:
        extra.append(torch.tensor([int(f) for f in flags], dtype=torch.int64,
                                  device=scene.pose.device))
    out = broadcast_state([getattr(scene, f) for f in fields] + extra, mesh)
    scene = scene._replace(**dict(zip(fields, out)))
    rest = out[len(fields):]
    if excluded is not None:
        excluded = rest.pop(0)
    return scene, excluded, rest[0].tolist() if flags else []


def _ba(scene: Scene, cam_in_ba, cfg: BAConfig, min_landmarks: int,
        program_iters: int = 0, abs_anchors=None, mesh=None):
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

    The observations are split over the ranks of ``mesh``
    (``parallel.make_mesh``; default: this process alone) by
    ``refine_ba_sharded``, after every rank has taken rank 0's scene state,
    so that all build the same problem.
    """
    N, K = scene.kp_mask.shape
    mesh = mesh or local_mesh(scene.pose.device)
    *state, cam_in_ba = broadcast_state(
        [getattr(scene, f) for f in _SCENE_STATE] + [cam_in_ba], mesh)
    scene = scene._replace(**dict(zip(_SCENE_STATE, state)))
    n_obs, n_lms = timer.readback(torch.Tensor.tolist,
                                  torch.stack(ba_problem_counts(scene, cam_in_ba)))
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
        poses, points, intr, info_r = refine_ba_sharded(prob, run_cfg, mesh)
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


def set_pose(scene: Scene, frame, T: torch.Tensor) -> Scene:
    """The scene with ``frame`` (an int, or an index tensor on the scene's
    device) registered at pose ``T``: selections by a mask made on the card,
    with no host value written to it."""
    on = torch.arange(scene.pose.shape[0], device=scene.pose.device) == frame
    return scene._replace(pose=torch.where(on[:, None, None], T, scene.pose),
                          pose_valid=scene.pose_valid | on)


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
    if match_tables is not None and len(match_tables) not in (3, 6):
        raise ValueError("match_tables is a 3-tuple or a 6-tuple; got "
                         f"{len(match_tables)} entries")
    dev = resolve_device(device)
    mesh = _mesh(opt, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(opt.seed)
    keypoints = as_tensor(keypoints, dev, torch.float32)
    descriptors = as_tensor(descriptors, dev, torch.float32)
    kp_mask = as_tensor(kp_mask, dev, torch.bool)
    N = keypoints.shape[0]
    intr = (intrinsics_from_image_size(*image_size, device=dev) if intr is None
            else as_tensor(intr, dev, torch.float32))
    # every rank starts from rank 0's features (see sync_ranks)
    keypoints, descriptors, kp_mask, intr = broadcast_state(
        [keypoints, descriptors, kp_mask, intr], mesh)
    seconds = {}
    t0 = time.perf_counter()

    def log(*a):
        if verbose:
            print(f"[sfm +{time.perf_counter() - t0:7.2f}s]", *a, flush=True)

    if opt.min_features_count > 0:
        enough = kp_mask.sum(1) >= opt.min_features_count
        kp_mask = kp_mask & enough[:, None]

    # ---- match graph ------------------------------------------------------
    with timer.span("sfm.matches") as sp:
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
                chunk=opt.match_chunk, verify=verify, pair_idx=cand, mesh=mesh)
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
    seconds["match_graph"] = sp.seconds
    del descriptors
    scene = make_scene(keypoints, kp_mask, pair_idx, pair_ok, m_ij, v_ij,
                       m_ji, v_ji, intr, lm_capacity=opt.lm_capacity)
    # the epipolar verification draws on each rank: rank 0's graph holds
    scene, _, _ = sync_ranks(mesh, scene, fields=Scene._fields)
    n_edges = int(pair_ok.sum())
    log(f"match graph: {n_edges}/{pair_idx.shape[0]} edges survive")
    stats = {"frames": N, "pairs": int(pair_idx.shape[0]), "edges": n_edges,
             "initialized": False, "init_pair": None, "pair_row": None,
             "n_good": 0, "used_homography": False, "seconds": seconds}

    # ---- initial pair: the search, then the seeding --------------------------
    n_good = used_h = 0
    with timer.span("sfm.pipeline.init_pair") as sp:
        score = rank_init_pairs(scene, float(max(image_size))).cpu().numpy()
        order = np.argsort(-score)
        order = order[score[order] > 0]
        pair_row, init = find_best_pair(
            generator, scene, order,
            min_initial_inliers=opt.min_initial_inliers,
            max_repr_error=opt.init_max_repr_error,
            min_tri_angle=opt.init_min_tri_angle,
            chunk=opt.init_chunk, n_hyp_e=opt.ransac_hyps_e, n_hyp_h=opt.ransac_hyps_h)
        if pair_row is not None:
            with timer.span("sfm.pipeline.seed") as sd:
                scene = seed_initial_pair(scene, pair_row, init.T, init.points, init.point_ok)
                _sync(dev)
            seconds["seed"] = sd.seconds
            n_good, used_h = int(init.n_good), int(init.used_homography)
    seconds["init_pair"] = sp.seconds - seconds.get("seed", 0.0)
    # the pair search draws on each rank: rank 0's pair (or none) holds
    scene, _, (pair_row, n_good, used_h) = sync_ranks(
        mesh, scene, None, -1 if pair_row is None else pair_row, n_good, used_h)
    if pair_row < 0:
        log("no initial pair found")
        return scene, stats
    i0, j0 = (int(x) for x in scene.pair_idx[pair_row].tolist())
    stats.update(initialized=True, init_pair=(i0, j0), pair_row=pair_row,
                 n_good=n_good, used_homography=bool(used_h), T_init=scene.pose[j0].clone())
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


def _mesh(opt: SfmOptions, dev: torch.device):
    """The run's mesh: this process alone for one device; for
    ``n_devices > 1`` the initialized process group of that many ranks (a
    ValueError that says how to launch otherwise)."""
    return local_mesh(dev) if opt.n_devices <= 1 else make_mesh(opt.n_devices, device=dev)


def _n_far(scene: Scene) -> int:
    """Surviving long-range edges: span above max(N // 4, 30) frames."""
    N = scene.kp_mask.shape[0]
    pi_np = scene.pair_idx.cpu().numpy()
    span = np.abs(pi_np[:, 1].astype(np.int64) - pi_np[:, 0])
    return int((scene.pair_ok.cpu().numpy() & (span > max(N // 4, 30))).sum())


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

    With ``pair_window > 0`` and long-range edges surviving (span above
    max(N // 4, 30)), the sweep is followed by the loop-closing stage
    (``device_loop`` runs only, as in the reference; ``loop_close``) and the
    finalization by the map-refinement rounds (``map_refine_rounds``; -1
    picks 3 here and 0 elsewhere).

    ``stats``: what ``initialize_sfm`` reports, plus ``registered``,
    ``excluded``, ``landmarks``, the global BA's ``global_ba`` (iterations,
    initial and final cost; None when it did not run), the sweep's
    ``local_ba`` (``calls`` and their LM ``iterations``), ``map_refine`` (one
    entry per refinement round), ``loop`` (the loop-closing stage, when it
    ran: see ``_close_loops``), ``checkpoints`` (scene checkpoints written,
    see ``resume_sfm``), and the wall seconds of ``sweep``, ``loop`` and
    ``finalize`` beside the earlier stages'.
    """
    opt = options
    dev = resolve_device(device)
    mesh = _mesh(opt, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(opt.seed)
    t0 = time.perf_counter()

    def log(*a):
        if verbose:
            print(f"[sfm +{time.perf_counter() - t0:7.2f}s]", *a, flush=True)

    with timer.span("sfm.pipeline.run_sfm"):
        scene, stats = initialize_sfm(
            keypoints, descriptors, kp_mask, image_size, intr=intr, options=opt,
            generator=generator, device=dev, match_tables=match_tables, verbose=verbose)
        N, K = scene.kp_mask.shape
        stats.update(registered=0, excluded=0, landmarks=0, global_ba=None,
                     local_ba={"calls": 0, "iterations": 0})
        if not stats["initialized"]:
            return scene, stats

        n_far = _n_far(scene)
        log(f"match graph: {n_far} long-range edges")
        fp_tbl = torch.as_tensor(frame_pair_table(scene.pair_idx.cpu().numpy(), N), device=dev)
        refine_cfg, global_cfg = _ba_configs(opt)

        # ---- incremental loop -------------------------------------------------
        written: list[int] = []
        with timer.span("sfm.device_loop") as sp:
            excluded = torch.zeros(N, dtype=torch.bool, device=dev)
            if opt.device_loop:
                on_segment = _with_checkpoint(_interim_ba(opt, global_cfg, log, mesh), opt, log,
                                              written, mesh)
                scene, excluded, n_reg = _sweep(scene, excluded, fp_tbl, generator, opt,
                                                refine_cfg, on_segment, mesh, stats["local_ba"])
                log(f"sweep: +{n_reg} frames registered, "
                    f"{timer.readback(int, excluded.sum())} excluded")
            else:
                scene, excluded = _host_loop(scene, excluded, fp_tbl, generator, opt, refine_cfg,
                                             log, stats["local_ba"])
                scene, excluded, _ = sync_ranks(mesh, scene, excluded)
            _sync(dev)
        stats["seconds"]["sweep"] = sp.seconds

        if opt.device_loop and opt.loop_close and opt.pair_window > 0 and n_far > 0:
            with timer.span("sfm.pipeline._close_loops") as sp:
                scene, stats["loop"] = _close_loops(scene, fp_tbl, generator, opt, n_far, log)
                _sync(dev)
            stats["seconds"]["loop"] = sp.seconds

        with timer.span("sfm.pipeline._finalize") as sp:
            scene, final = _finalize(scene, excluded, opt, global_cfg, log,
                                     abs_anchors=abs_anchors, fp_tbl=fp_tbl, n_loop_edges=n_far,
                                     mesh=mesh)
            _sync(dev)
        stats["seconds"]["finalize"] = sp.seconds
        stats.update(final, checkpoints=len(written))
        log(f"done: {stats['registered']}/{N} frames registered, {stats['landmarks']} landmarks")
        return scene, stats


def _interim_ba(opt: SfmOptions, global_cfg: BAConfig, log, mesh=None):
    """The sweep's between-segment hook: a short global BA that arrests the
    drift of a long local-window sweep (None when ``interim_ba_iters`` is 0)."""
    if opt.interim_ba_iters <= 0:
        return None
    interim_cfg = global_cfg._replace(max_iters=opt.interim_ba_iters)

    def on_segment(s):
        with timer.span("ba.interim") as sp:
            s, info = _ba(s, s.pose_valid, interim_cfg, opt.min_ba_landmarks,
                          program_iters=opt.ba_program_iters, mesh=mesh)
            if info is not None:
                sp.add("iterations", info["iterations"])
        if info is not None:
            log(f"interim BA: {float(info['initial_cost']):.1f} -> "
                f"{float(info['final_cost']):.1f}")
        return s

    return on_segment


def _with_checkpoint(on_segment, opt: SfmOptions, log, written: list | None = None,
                     mesh=None):
    """Wrap a sweep's ``on_segment`` hook with a scene checkpoint
    (``opt.checkpoint_path``) after every ``opt.checkpoint_every``-th
    segment: the crash-resume hook. Appends the segment number of each
    write to ``written``. Under a mesh of several ranks rank 0 writes."""
    if not opt.checkpoint_path:
        return on_segment
    seg = 0

    def cb(s):
        nonlocal seg
        if on_segment is not None:
            s = on_segment(s)
        seg += 1
        if seg % max(opt.checkpoint_every, 1) == 0:
            from eacham_tpu_torch.io.checkpoint import save_scene

            if mesh is None or mesh.rank == 0:
                save_scene(opt.checkpoint_path, s)
            if written is not None:
                written.append(seg)
            log(f"checkpoint: segment {seg} -> {opt.checkpoint_path}")
        return s

    return cb


def _sweep(scene: Scene, excluded, fp_tbl, generator, opt: SfmOptions, refine_cfg: BAConfig,
           on_segment, mesh=None, local_ba=None):
    """``device_loop.registration_sweep`` with a run's options. Returns
    (scene, excluded, n_registered); the local BAs add their calls and
    iterations to ``local_ba``."""
    from eacham_tpu_torch.sfm.device_loop import registration_sweep

    N, K = scene.kp_mask.shape
    return registration_sweep(
        scene, excluded, fp_tbl, generator, opt.max_repr_error, opt.min_tri_angle,
        min_pnp_inliers=opt.min_pnp_inliers, min_ba_landmarks=opt.min_ba_landmarks,
        ba_cfg=refine_cfg, max_observers=opt.max_observers,
        n_hyp_pnp=opt.ransac_hyps_pnp, pnp_pair_only=opt.pnp_pair_only,
        ba_max_cams=opt.local_ba_max_cams,
        # a window of C cameras holds at most C * K observations
        ba_max_obs=min(opt.local_ba_max_obs, min(opt.local_ba_max_cams, N) * K),
        ba_max_lms=opt.local_ba_max_lms, ba_every=opt.local_ba_every,
        ba_free_span=opt.local_ba_free_span, segment=opt.sweep_segment,
        on_segment=on_segment, mesh=mesh, local_ba=local_ba)


@torch.no_grad()
def resume_sfm(
    scene: Scene,
    options: SfmOptions = SfmOptions(),
    excluded=None,
    verbose: bool = True,
    finalize: bool = True,
    abs_anchors: tuple | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = "cuda",
):
    """Continue a reconstruction from a (possibly checkpointed) Scene.

    Re-runs the registration sweep over still-unregistered frames (with the
    interim-BA cadence and the checkpoints of ``run_sfm``'s sweep) and, with
    ``finalize``, the global-BA finalization. ``finalize=False`` is the
    streaming fast path: new frames get local-window refinement only, and
    the caller amortizes the global solve over windows
    (``StreamingReconstructor(finalize_every=...)``). ``generator`` drives
    the PnP draws; by default it is seeded ``options.seed + 1``.

    Returns ``(scene, stats)``: ``registered``, ``landmarks``,
    ``initialized``, ``checkpoints`` (writes made), the sweep's ``local_ba``
    (as ``run_sfm``'s) and the wall ``seconds``
    of ``sweep`` (and ``finalize``), then with ``finalize`` ``excluded``,
    ``global_ba``, ``map_refine`` and ``init_pair`` (-1, -1), without it
    ``finalized`` False. The finalization runs the map-refinement rounds
    as ``run_sfm``'s does; a resume has no loop-closing stage, as in the
    reference.
    """
    opt = options
    dev = resolve_device(device)
    mesh = _mesh(opt, dev)
    with timer.span("sfm.pipeline.resume_sfm"):
        scene = Scene(*(as_tensor(x, dev) for x in scene))
        N, K = scene.kp_mask.shape
        excluded = (torch.zeros(N, dtype=torch.bool, device=dev) if excluded is None
                    else as_tensor(excluded, dev, torch.bool))
        scene, excluded, _ = sync_ranks(mesh, scene, excluded, fields=Scene._fields)

        def log(*a):
            if verbose:
                print("[sfm]", *a, flush=True)

        if int(scene.pose_valid.sum()) < 2:
            log("resume: scene has no initialized pair")
            return scene, {"registered": 0, "landmarks": 0, "initialized": False}

        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(opt.seed + 1)
        fp_tbl = torch.as_tensor(frame_pair_table(scene.pair_idx.cpu().numpy(), N), device=dev)
        refine_cfg, global_cfg = _ba_configs(opt)
        written: list[int] = []
        local_ba = {"calls": 0, "iterations": 0}
        with timer.span("sfm.device_loop") as sp:
            on_segment = _with_checkpoint(_interim_ba(opt, global_cfg, log, mesh), opt, log,
                                          written, mesh)
            scene, excluded, n_reg = _sweep(scene, excluded, fp_tbl, generator, opt, refine_cfg,
                                            on_segment, mesh, local_ba)
            _sync(dev)
        seconds = {"sweep": sp.seconds}
        log(f"resume sweep: +{n_reg} frames registered")
        if not finalize:
            return scene, {"registered": int((scene.pose_valid & ~excluded).sum()),
                           "landmarks": int(scene.lm_valid.sum()), "initialized": True,
                           "finalized": False, "checkpoints": len(written), "seconds": seconds,
                           "local_ba": local_ba}
        with timer.span("sfm.pipeline._finalize") as sp:
            scene, stats = _finalize(scene, excluded, opt, global_cfg, log,
                                     abs_anchors=abs_anchors, fp_tbl=fp_tbl,
                                     n_loop_edges=_n_far(scene), mesh=mesh)
            _sync(dev)
        seconds["finalize"] = sp.seconds
        stats.update(initialized=True, init_pair=(-1, -1), checkpoints=len(written),
                     seconds=seconds, local_ba=local_ba)
        log(f"done: {stats['registered']}/{N} frames registered, {stats['landmarks']} landmarks")
        return scene, stats


def _host_loop(scene, excluded, fp_tbl, generator, opt: SfmOptions, refine_cfg, log, local_ba):
    """The plain per-frame loop (``device_loop=False``): a local BA over all
    registered neighbours at every registration, no segments, no interim
    BA. Returns (scene, excluded); the local BAs add their calls and
    iterations to ``local_ba``."""
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
        if info is not None:
            local_ba["calls"] += 1
            local_ba["iterations"] += info["iterations"]
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


def _close_loops(scene: Scene, fp_tbl, generator, opt: SfmOptions, n_far: int, log):
    """The loop-closing stage after the sweep. Returns (scene, stats).

    Every surviving non-window edge (span above ``pair_window``: ladder
    rungs, retrieval hits, true loop closures) gets a metric PnP
    measurement against the earlier frame's local map. If the sweep's own
    loop consistency is above ``pgo_min_consistency_deg`` (otherwise it is
    at the measurement noise floor and the stage is skipped): above
    ``submap_align_min_deg`` rigid submaps are aligned first and kept if
    they cut the consistency below 0.75 of it; then the essential-matrix
    edge measurements and the frame pose graph, whose solution is accepted
    if it at least halves the consistency (after an applied submap
    alignment: if it ends under the noise floor). The map is rebuilt under
    an accepted solution or applied submaps.

    ``stats``: ``n_far``, ``loop_rows`` (edges measured), ``err0`` (the
    sweep's consistency, degrees), ``err_submap`` and ``err_pgo`` (None
    where not run), ``decision`` (``skipped``, ``rejected`` or
    ``accepted``), ``submap`` (the alignment was applied), ``landmarks``
    after a rebuild, and the wall ``seconds`` of ``measure``, ``submap``,
    ``edges``, ``solve`` and ``rebuild``.
    """
    N = scene.kp_mask.shape[0]
    dev = scene.pose.device
    pi_np = scene.pair_idx.cpu().numpy()
    span = np.abs(pi_np[:, 1].astype(np.int64) - pi_np[:, 0])
    rows_np = np.flatnonzero(scene.pair_ok.cpu().numpy() & (span > opt.pair_window))
    rows = np.concatenate([rows_np, np.full((-len(rows_np)) % 8, -1)])
    loop_rows = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    secs = {}
    st = {"n_far": n_far, "loop_rows": int(len(rows_np)), "err0": None, "err_submap": None,
          "err_pgo": None, "decision": "skipped", "submap": False, "landmarks": None,
          "seconds": secs}

    t = time.perf_counter()
    T_loop, w_loop = loop_pnp_measurements(
        scene.pose, scene.points, scene.lm_valid, scene.kp2lm, scene.keypoints,
        scene.pair_idx, scene.match_ij, scene.valid_ij, scene.intr, loop_rows, generator,
        px_threshold=opt.max_repr_error, n_hyp=opt.ransac_hyps_pnp)
    err0 = loop_consistency(scene.pose, pi_np, loop_rows, T_loop, w_loop)
    secs["measure"] = time.perf_counter() - t
    st["err0"] = err0
    if not np.isfinite(err0) or err0 <= opt.pgo_min_consistency_deg:
        log(f"pose graph skipped (loop consistency {err0:.2f} deg is at the measurement "
            "noise floor)")
        return scene, st
    submap_applied = False
    if err0 > opt.submap_align_min_deg:
        # drift beyond the frame pose graph's linearization range: align
        # rigid submaps first (host float64 Sim(3) graph)
        t = time.perf_counter()
        pose_sub = submap_align(
            to_numpy(scene.pose), to_numpy(scene.pose_valid), to_numpy(scene.pose_fixed),
            pi_np, to_numpy(loop_rows), to_numpy(T_loop), to_numpy(w_loop),
            size=opt.submap_size)
        err_sub = loop_consistency(pose_sub, pi_np, loop_rows, T_loop, w_loop)
        secs["submap"] = time.perf_counter() - t
        st["err_submap"] = err_sub
        if np.isfinite(err_sub) and err_sub < 0.75 * err0:
            scene = scene._replace(pose=torch.as_tensor(pose_sub, device=dev))
            log(f"submap align: loop consistency {err0:.2f} -> {err_sub:.2f} deg "
                f"({int(np.ceil(N / opt.submap_size))} submaps)")
            err0 = err_sub
            submap_applied = True
        else:
            log(f"submap align rejected ({err0:.2f} -> {err_sub:.2f} deg)")
    t = time.perf_counter()
    T_meas, w_meas = edge_measurements(
        scene.keypoints, scene.pair_idx, scene.pair_ok, scene.match_ij, scene.valid_ij,
        scene.intr, generator, px_threshold=opt.max_repr_error)
    _sync(dev)
    secs["edges"] = time.perf_counter() - t
    t = time.perf_counter()
    pose_pg = optimize_pose_graph(
        scene.pose, scene.pose_valid, scene.pose_fixed, pi_np, T_meas, w_meas,
        iters=opt.pgo_iters, loop_rows=loop_rows, T_loop=T_loop, w_loop=w_loop)
    err1 = loop_consistency(pose_pg, pi_np, loop_rows, T_loop, w_loop)
    secs["solve"] = time.perf_counter() - t
    st["err_pgo"] = err1
    # a marginal gain near the noise floor means the solve wandered within
    # the modes the measurements cannot pin: demand at least a halving, or,
    # after submap alignment, a result under the noise floor
    accept = bool(np.isfinite(err1) and (
        err1 < 0.5 * err0
        or (submap_applied and err1 < min(err0, opt.pgo_min_consistency_deg))))
    st.update(decision="accepted" if accept else "rejected", submap=submap_applied)
    if accept:
        scene = scene._replace(pose=pose_pg)
    if accept or submap_applied:
        # corrected poses invalidate the old landmark table
        t = time.perf_counter()
        scene = rebuild_map(scene, fp_tbl, opt.max_repr_error, opt.min_tri_angle,
                            max_observers=opt.max_observers, segment=opt.sweep_segment or 128)
        _sync(dev)
        secs["rebuild"] = time.perf_counter() - t
        st["landmarks"] = int(scene.lm_valid.sum())
    if accept:
        log(f"pose graph: {n_far} loop edges closed (consistency {err0:.2f} -> {err1:.2f} "
            f"deg), map rebuilt ({st['landmarks']} landmarks)")
    else:
        log(f"pose graph: correction rejected (loop consistency {err0:.2f} -> {err1:.2f} "
            f"deg), keeping {'submap-aligned' if submap_applied else 'sweep'} poses")
    return scene, st


def _ba_record(info):
    """The JSON-ready summary of one BA's info (None when it did not run)."""
    if info is None:
        return None
    return {"iterations": info["iterations"], "initial_cost": float(info["initial_cost"]),
            "final_cost": float(info["final_cost"])}


def _finalize(scene: Scene, excluded, opt: SfmOptions, global_cfg: BAConfig, log,
              abs_anchors=None, fp_tbl=None, n_loop_edges: int = 0, mesh=None):
    """Prune, global BA, prune, and a second BA when the second prune
    changed the problem (at least 0.1% of the observations, and 8, removed);
    then the map-refinement rounds, each a ``rebuild_map`` under the
    BA-improved poses, a prune and a global BA. ``map_refine_rounds`` -1
    (AUTO) means 3 rounds for a windowed run (``pair_window > 0``) with
    long-range edges (``n_loop_edges > 0``) and ``fp_tbl`` given, else 0:
    the rebuild re-merges the tracks that drift forced apart. Every global
    BA is sharded over ``mesh`` when one is given. Returns (scene, run
    statistics)."""
    refine_rounds = opt.map_refine_rounds
    if refine_rounds < 0:
        refine_rounds = 3 if (opt.pair_window > 0 and n_loop_edges > 0
                              and fp_tbl is not None) else 0
    ba_info = None
    rounds = []

    def global_ba(s):
        with timer.span("ba.global") as sp:
            s, info = _ba(s, s.pose_valid, global_cfg, opt.min_ba_landmarks,
                          program_iters=opt.ba_program_iters, abs_anchors=abs_anchors,
                          mesh=mesh)
            if info is not None:
                sp.add("iterations", info["iterations"])
        return s, info

    if opt.run_global_ba and opt.global_max_iters > 0:
        if opt.prune_outliers:
            scene, n_obs, n_lm = prune_observations(scene, opt.max_repr_error)
            log(f"prune: -{int(n_obs)} observations, -{int(n_lm)} landmarks")
        scene, info = global_ba(scene)
        if info is not None:
            ba_info = {**_ba_record(info), "second": None}
            log(f"global BA: {ba_info['initial_cost']:.1f} -> {ba_info['final_cost']:.1f} "
                f"({ba_info['iterations']} iters)")
        if opt.prune_outliers and info is not None:
            scene, n_obs, n_lm = prune_observations(scene, opt.max_repr_error)
            total_obs = int(((scene.kp2lm >= 0) & scene.kp_mask
                             & scene.pose_valid[:, None]).sum())
            _, _, (n_obs, total_obs) = sync_ranks(mesh, scene, None, int(n_obs), total_obs,
                                                  fields=())
            if n_obs >= max(8, total_obs // 1000):
                scene, info2 = global_ba(scene)
                if info2 is not None:
                    ba_info["second"] = _ba_record(info2)
                    log(f"global BA 2 (post-prune -{n_obs} obs): "
                        f"{ba_info['second']['initial_cost']:.1f} -> "
                        f"{ba_info['second']['final_cost']:.1f}")
            else:
                log(f"global BA 2 skipped (prune removed {n_obs} obs of {total_obs})")

        for _ in range(refine_rounds if fp_tbl is not None else 0):
            dev = scene.pose.device
            t = time.perf_counter()
            scene = rebuild_map(scene, fp_tbl, opt.max_repr_error, opt.min_tri_angle,
                                max_observers=opt.max_observers,
                                segment=opt.sweep_segment or 128)
            rebuilt = int(scene.lm_valid.sum())
            t_rebuild = time.perf_counter() - t
            t = time.perf_counter()
            scene, n_obs, _ = prune_observations(scene, opt.max_repr_error)
            scene, info3 = global_ba(scene)
            _sync(dev)
            rounds.append({"rebuilt_landmarks": rebuilt, "pruned_observations": int(n_obs),
                           "landmarks": int(scene.lm_valid.sum()), "ba": _ba_record(info3),
                           "seconds": {"rebuild": t_rebuild, "ba": time.perf_counter() - t}})
            if info3 is not None:
                log(f"map refine: rebuilt {rounds[-1]['landmarks']} landmarks "
                    f"(pruned {int(n_obs)} obs), BA {float(info3['initial_cost']):.1f} -> "
                    f"{float(info3['final_cost']):.1f}")
    return scene, {"registered": int(scene.pose_valid.sum()),
                   "excluded": int(excluded.sum()),
                   "landmarks": int(scene.lm_valid.sum()), "global_ba": ba_info,
                   "map_refine": rounds}
