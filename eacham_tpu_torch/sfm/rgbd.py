"""Metric-scale reconstruction from RGB-D or rectified stereo frames (port
of eacham_tpu/sfm/rgbd.py).

Depth-seeded landmarks make the reconstruction metric from frame zero: no
essential-matrix scale ambiguity and no similarity fix-up. The sequential
PnP chain reuses the monocular machinery (``pnp_register``, the ``Scene``
tables, ``_ba``); what is new is the depth backprojection and the landmark
adoption, both O(K) masked tensor operations.

  1. frame 0 fixed at identity; its keypoints backproject through the depth
     channel into metric landmarks;
  2. each later frame: PnP against the metric map, then adoption of its
     registered neighbours' landmarks for matched keypoints, then depth
     seeding of the rest from its own depth channel;
  3. optional global BA (landmark priors of sigma 1 / observers anchor the
     metric scale while poses and points polish).

The match graph is one launch of the batched matcher on the card
(``build_match_tables``, no epipolar verification, as in the reference).
"""

from __future__ import annotations

import time

import torch

from eacham_tpu_torch.ba.core import BAConfig
from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.geometry.se3 import inverse_se3
from eacham_tpu_torch.sfm.matches import build_match_tables, observers_of_frame
from eacham_tpu_torch.sfm.pipeline import SfmOptions, _ba, _sync, pnp_register, set_pose
from eacham_tpu_torch.sfm.scene import Scene, alloc_landmarks, frame_pair_table, make_scene
from eacham_tpu_torch.sfm.triangulate import first_true


def depth_at_keypoints(depth_maps, xy, device: str | torch.device | None = "cuda"):
    """Per-keypoint depth [N, K] sampled from [N, H, W] maps at [N, K, 2]
    pixels (truncated to integers, clamped to the map)."""
    dev = resolve_device(device)
    depth_maps = as_tensor(depth_maps, dev, torch.float32)
    xy = as_tensor(xy, dev, torch.float32)
    N, H, W = depth_maps.shape
    xi = torch.clamp(xy[..., 0].long(), 0, W - 1)
    yi = torch.clamp(xy[..., 1].long(), 0, H - 1)
    return depth_maps[torch.arange(N, device=dev)[:, None], yi, xi]


def stereo_depth_at_keypoints(xy, right_x, intr, baseline: float,
                              device: str | torch.device | None = "cuda"):
    """Per-keypoint metric depth from rectified stereo matches: z = f * B /
    disparity. Disparity of 0.1 px or less yields z = 0 (invalid)."""
    dev = resolve_device(device)
    xy = as_tensor(xy, dev, torch.float32)
    right_x = as_tensor(right_x, dev, torch.float32)
    intr = as_tensor(intr, dev, torch.float32)
    disparity = xy[..., 0] - right_x
    return torch.where(disparity > 0.1,
                       intr[0] * baseline / torch.clamp(disparity, min=0.1), 0.0)


def _backproject(uv: torch.Tensor, z: torch.Tensor, intr: torch.Tensor,
                 T_w2c: torch.Tensor) -> torch.Tensor:
    """Pixels + depth -> world points under the world->cam pose T."""
    x = (uv[..., 0] - intr[2]) / intr[0] * z
    y = (uv[..., 1] - intr[3]) / intr[1] * z
    pc = torch.stack([x, y, z], -1)
    T_c2w = inverse_se3(T_w2c)
    return pc @ T_c2w[:3, :3].T + T_c2w[:3, 3]


def _seed_frame(scene: Scene, cur: int, kp_z: torch.Tensor, max_depth: float):
    """Depth-seed landmarks for ``cur``'s still-unlinked keypoints.
    Returns (scene, number seeded as a 0-d tensor)."""
    ok = (scene.kp_mask[cur] & (kp_z > 0.0) & (kp_z < max_depth)
          & (scene.kp2lm[cur] < 0))
    pts_w = _backproject(scene.keypoints[cur], kp_z, scene.intr, scene.pose[cur])
    scene, ids = alloc_landmarks(scene, pts_w, ok)
    got = ids >= 0
    kp2lm = scene.kp2lm.clone()
    kp2lm[cur] = torch.where(got, ids, kp2lm[cur])
    return scene._replace(kp2lm=kp2lm), got.sum()


def _adopt_links(scene: Scene, cur: int, pair_rows: torch.Tensor):
    """Adopt registered neighbours' landmarks for matched keypoints of
    ``cur``: the link half of triangulation's merge logic, no triangulation
    needed. Each keypoint takes the landmark of its first observer in
    ``pair_rows`` order that has one. Returns (scene, number adopted)."""
    K = scene.kp_mask.shape[1]
    obs_frame, obs_kp, obs_on = observers_of_frame(
        cur, pair_rows, scene.pair_idx, scene.pair_ok,
        scene.match_ij, scene.valid_ij, scene.match_ji, scene.valid_ji)
    obs_on = obs_on & scene.pose_valid[obs_frame][:, None] & scene.kp_mask[cur][None, :]
    nb_lm = scene.kp2lm[obs_frame[:, None], obs_kp].long()
    has = obs_on & (nb_lm >= 0) & scene.lm_valid[torch.clamp(nb_lm, min=0)]
    src, any_has = first_true(has, 0)
    ok = any_has & (scene.kp2lm[cur] < 0)
    lm_id = torch.clamp(nb_lm, min=0)[src, torch.arange(K, device=src.device)]
    kp2lm = scene.kp2lm.clone()
    kp2lm[cur] = torch.where(ok, lm_id.to(kp2lm.dtype), kp2lm[cur])
    return scene._replace(kp2lm=kp2lm), ok.sum()


@torch.no_grad()
def run_sfm_rgbd(
    keypoints,                 # [N, K, 2]
    descriptors,               # [N, K, D] L2-normalized
    kp_mask,                   # [N, K]
    kp_depth,                  # [N, K] metric depth per keypoint (0 = invalid)
    intr,                      # [4]
    options: SfmOptions = SfmOptions(),
    max_depth: float = 100.0,
    verbose: bool = True,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = "cuda",
):
    """Metric sequential reconstruction (see the module docstring).

    ``kp_depth`` comes from ``depth_at_keypoints`` (RGB-D) or
    ``stereo_depth_at_keypoints`` (rectified stereo). ``generator`` drives
    the PnP draws; by default it is seeded from ``options.seed``. Returns
    ``(scene, stats)`` with poses in the depth channel's metric scale;
    ``stats`` holds ``registered``, ``landmarks``, ``initialized``, the
    global BA's ``global_ba`` record (None when it did not run) and the wall
    ``seconds`` of ``match_graph``, ``sweep`` and ``global_ba``.
    """
    opt = options
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(opt.seed)
    keypoints = as_tensor(keypoints, dev, torch.float32)
    descriptors = as_tensor(descriptors, dev, torch.float32)
    kp_mask = as_tensor(kp_mask, dev, torch.bool)
    kp_depth = as_tensor(kp_depth, dev, torch.float32)
    intr = as_tensor(intr, dev, torch.float32)
    N, K = kp_mask.shape
    seconds = {}

    def log(*a):
        if verbose:
            print("[rgbd]", *a, flush=True)

    t = time.perf_counter()
    tables = build_match_tables(descriptors, kp_mask, ratio=opt.match_ratio,
                                min_matches=opt.min_matches, chunk=opt.match_chunk)
    _sync(dev)
    seconds["match_graph"] = time.perf_counter() - t
    scene = make_scene(keypoints, kp_mask, *tables, intr=intr,
                       lm_capacity=opt.lm_capacity or N * K)
    fp_tbl = torch.as_tensor(frame_pair_table(tables[0].cpu().numpy(), N), device=dev)

    # frame 0: gauge and metric anchor
    t = time.perf_counter()
    pose_valid, pose_fixed = scene.pose_valid.clone(), scene.pose_fixed.clone()
    pose_valid[0], pose_fixed[0] = True, True
    scene = scene._replace(pose_valid=pose_valid, pose_fixed=pose_fixed)
    scene, n0 = _seed_frame(scene, 0, kp_depth[0], max_depth)
    if verbose:
        log(f"frame 0: {int(n0)} depth-seeded landmarks (metric anchor)")

    registered = 1
    for f in range(1, N):
        T, n_inl = pnp_register(scene, f - 1, f, fp_tbl[f], generator, threshold=4.0,
                                n_hyp=opt.ransac_hyps_pnp)
        n_inl = int(n_inl)
        if n_inl < opt.min_pnp_inliers:
            log(f"frame {f}: PnP failed ({n_inl} inliers), skipped")
            continue
        scene = set_pose(scene, f, T)
        scene, n_adopt = _adopt_links(scene, f, fp_tbl[f])
        scene, n_new = _seed_frame(scene, f, kp_depth[f], max_depth)
        registered += 1
        if verbose:
            log(f"frame {f}: PnP {n_inl} inl, adopted {int(n_adopt)}, seeded {int(n_new)}")
    _sync(dev)
    seconds["sweep"] = time.perf_counter() - t

    t = time.perf_counter()
    ba_rec = None
    if opt.run_global_ba and opt.global_max_iters > 0:
        global_cfg = BAConfig(
            max_iters=opt.global_max_iters, tolerance=opt.global_tolerance,
            method=opt.global_method.lower(), trust_radius_init=opt.global_delta,
            solver=opt.global_solver)
        scene, info = _ba(scene, scene.pose_valid, global_cfg, opt.min_ba_landmarks)
        if info is not None:
            ba_rec = {"iterations": info["iterations"],
                      "initial_cost": float(info["initial_cost"]),
                      "final_cost": float(info["final_cost"])}
            log(f"global BA: {ba_rec['initial_cost']:.1f} -> {ba_rec['final_cost']:.1f}")
    _sync(dev)
    seconds["global_ba"] = time.perf_counter() - t

    stats = {"registered": registered, "landmarks": int(scene.lm_valid.sum()),
             "initialized": True, "global_ba": ba_rec, "seconds": seconds}
    log(f"done: {registered}/{N} frames, {stats['landmarks']} landmarks")
    return scene, stats
