"""Pose-graph optimization: loop closing for long trajectories (port of
eacham_tpu/sfm/posegraph.py).

The incremental sweep refines a small camera window per frame, so pose
error accumulates along the trajectory; by the time a loop closes, the
reprojection-gated landmark merge rejects every loop link and the global BA
never sees a long-range constraint. Loops are therefore closed in POSE
space:

  1. ``loop_pnp_measurements``: every long-range edge (i, j) registers
     frame j against the 3-D map around frame i (PnP, batched over the
     edges in chunks) -> a metric relative SE(3) with the local map's scale;
     ``edge_measurements``: essential-matrix MSAC + cheirality per match
     edge -> relative rotation and unit translation direction (batched over
     the pair axis in chunks).
  2. ``optimize_pose_graph``: rotation averaging, then a linear solve for
     camera centres and per-camera scales. Both stages assemble block-sparse
     float64 normal equations on the HOST (analytic 3x3 blocks, vectorized
     COO assembly, sparse LU): the graph solve is small and precision
     critical, and fp32 rounding alone perturbs its soft bending modes.
  3. ``rebuild_map``: with drift-free poses, wipe the landmark table and
     re-run the per-frame merge/triangulation pass so that loop links
     connect; the global BA then polishes everything.

The measurements run on the scene's device; everything else here is host
numpy and scipy, as in the reference, whose host functions are copied
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from eacham_tpu_torch.device import to_numpy
from eacham_tpu_torch.geometry.camera import pixel_to_normalized
from eacham_tpu_torch.geometry.epipolar import estimate_essential, recover_pose
from eacham_tpu_torch.geometry.pnp import solve_pnp_ransac
from eacham_tpu_torch.geometry.se3 import inverse_se3
from eacham_tpu_torch.sfm.scene import Scene
from eacham_tpu_torch.sfm.triangulate import triangulate_frame


def _gather_kps(keypoints: torch.Tensor, frames: torch.Tensor, match: torch.Tensor):
    """keypoints[frames[p]][match[p]] for every row p -> [P, K, 2]."""
    return torch.gather(keypoints[frames], 1, match.long()[..., None].expand(-1, -1, 2))


@torch.no_grad()
def edge_measurements(
    keypoints: torch.Tensor,    # [N, K, 2]
    pair_idx: torch.Tensor,     # [P, 2]
    pair_ok: torch.Tensor,      # [P]
    match_ij: torch.Tensor,     # [P, K]
    valid_ij: torch.Tensor,     # [P, K]
    intr: torch.Tensor,         # [4]
    generator: torch.Generator | None = None,
    px_threshold: float = 4.0,
    n_hyp: int = 128,
    chunk: int = 256,
    sample_idx: torch.Tensor | None = None,   # [P, n_hyp, 8]
):
    """Relative-pose measurement per match edge, ``chunk`` edges per
    batched pass.

    Returns ``(T_meas [P, 4, 4], weight [P])``: T_meas maps cam_i coords to
    cam_j (the two-view convention of recover_pose), translation normalized
    to unit length; weight is the cheirality-consistent inlier count (0
    where the edge is off or the estimate unusable).
    """
    P = match_ij.shape[0]
    f_mean = 0.5 * (intr[0] + intr[1])
    thr = torch.full_like(f_mean, px_threshold) / f_mean
    pi = pair_idx.long()
    valid = valid_ij & pair_ok[:, None]
    Ts, ws = [], []
    for s in range(0, P, chunk):
        p = pi[s:s + chunk]
        xy1 = pixel_to_normalized(keypoints[p[:, 0]], intr)
        xy2 = pixel_to_normalized(_gather_kps(keypoints, p[:, 1], match_ij[s:s + chunk]), intr)
        v = valid[s:s + chunk]
        res = estimate_essential(
            xy1, xy2, v, thr, n_hyp=n_hyp, generator=generator,
            sample_idx=None if sample_idx is None else sample_idx[s:s + chunk])
        T, n_good, _ = recover_pose(res.model, xy1, xy2, res.inliers)
        t = T[:, :3, 3]
        T = T.clone()
        T[:, :3, 3] = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-9)
        Ts.append(T)
        ws.append(n_good.to(torch.float32))
    return torch.cat(Ts), torch.where(pair_ok, torch.cat(ws), 0.0)


@torch.no_grad()
def loop_pnp_measurements(
    pose: torch.Tensor,        # [N, 4, 4] current (drifted) world->cam
    points: torch.Tensor,      # [L, 3]
    lm_valid: torch.Tensor,    # [L]
    kp2lm: torch.Tensor,       # [N, K]
    keypoints: torch.Tensor,   # [N, K, 2]
    pair_idx: torch.Tensor,    # [P, 2]
    match_ij: torch.Tensor,    # [P, K]
    valid_ij: torch.Tensor,    # [P, K]
    intr: torch.Tensor,        # [4]
    loop_rows: torch.Tensor,   # [Pl] int32 row ids into the pair axis (-1 pad)
    generator: torch.Generator | None = None,
    px_threshold: float = 4.0,
    n_hyp: int = 256,
    chunk: int = 64,
    sample_idx: torch.Tensor | None = None,   # [Pl, n_hyp, 6]
):
    """Metric loop-edge measurement: PnP of frame j against frame i's map.

    Frame i's keypoint->landmark links, composed with the verified i->j
    matches, give 3D-2D correspondences in the map frame around i (locally
    consistent even under global drift); MSAC PnP yields T_pnp (map->cam_j)
    and ``T_rel = T_pnp @ pose_i^-1``: the full relative SE(3), with the
    local map's scale. The reference scans the rows one at a time; here
    ``chunk`` rows are one batched RANSAC.

    Returns ``(T_rel [Pl, 4, 4], weight [Pl])``: weight is the PnP inlier
    count (0 for pad rows and failed edges).
    """
    rows = loop_rows.long()
    Pl = rows.shape[0]
    Ts, ws = [], []
    for s in range(0, Pl, chunk):
        r = rows[s:s + chunk]
        p = torch.clamp(r, min=0)
        i = pair_idx[p, 0].long()
        j = pair_idx[p, 1].long()
        lm = kp2lm[i].long()                                # [C, K]
        lm_safe = torch.clamp(lm, min=0)
        on = valid_ij[p] & (lm >= 0) & lm_valid[lm_safe]
        uv = _gather_kps(keypoints, j, match_ij[p])         # [C, K, 2]
        T_pnp, _, n_inl = solve_pnp_ransac(
            points[lm_safe], uv, on, intr, px_threshold, n_hyp=n_hyp, generator=generator,
            sample_idx=None if sample_idx is None else sample_idx[s:s + chunk])
        Ts.append(T_pnp @ inverse_se3(pose[i]))
        ws.append(torch.where(r >= 0, n_inl.to(torch.float32), 0.0))
    if not Ts:
        return (torch.zeros((0, 4, 4), dtype=pose.dtype, device=pose.device),
                torch.zeros(0, dtype=torch.float32, device=pose.device))
    return torch.cat(Ts), torch.cat(ws)


def _log_so3_np(R: np.ndarray) -> np.ndarray:
    """SO(3) log, batched, host float64 (gradient-free counterpart of
    ``_log_so3`` for the sparse pose-graph solver)."""
    trace = np.trace(R, axis1=-2, axis2=-1)
    cos_t = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    small = theta < 1e-6
    s = np.where(small, 1.0, np.sin(theta))
    k = np.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * s))
    Rd = R - np.swapaxes(R, -1, -2)
    return k[..., None] * np.stack(
        [Rd[..., 2, 1], Rd[..., 0, 2], Rd[..., 1, 0]], axis=-1)


def _exp_so3_np(w: np.ndarray) -> np.ndarray:
    """SO(3) exp, batched, host float64."""
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-8
    th = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - theta ** 2 / 6.0, np.sin(th) / th)
    b = np.where(small, 0.5 - theta ** 2 / 24.0, (1.0 - np.cos(th)) / th ** 2)
    W = _hat_np(w)
    I = np.broadcast_to(np.eye(3), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _hat_np(w: np.ndarray) -> np.ndarray:
    O = np.zeros(w.shape[:-1])
    return np.stack([
        np.stack([O, -w[..., 2], w[..., 1]], axis=-1),
        np.stack([w[..., 2], O, -w[..., 0]], axis=-1),
        np.stack([-w[..., 1], w[..., 0], O], axis=-1),
    ], axis=-2)


def _jr_inv_np(phi: np.ndarray) -> np.ndarray:
    """Inverse right Jacobian of SO(3) (batched, float64):
    log(A exp(u^)) ~= log(A) + Jr_inv(log A) u."""
    theta = np.linalg.norm(phi, axis=-1)
    small = theta < 1e-6
    th = np.where(small, 1.0, theta)
    cot = np.where(small, 1.0 / 12.0 + theta ** 2 / 720.0,
                   1.0 / th ** 2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th)))
    W = _hat_np(phi)
    I = np.broadcast_to(np.eye(3), W.shape)
    return I + 0.5 * W + cot[..., None, None] * (W @ W)


def _block_triplets(bi, bj, B, rows, cols, vals,
                    stride_r=3, stride_c=3, off_r=0, off_c=0):
    """Append COO triplets for [E, a, b] blocks B at block coords (bi, bj).

    ``stride_r``/``stride_c`` are the per-node variable widths at the
    block's row/col axes; ``off_r``/``off_c`` shift into a larger variable
    vector (e.g. the per-camera scale tail of the center system).
    """
    E, a, b = B.shape
    r = (off_r + stride_r * bi)[:, None, None] + np.arange(a)[None, :, None]
    c = (off_c + stride_c * bj)[:, None, None] + np.arange(b)[None, None, :]
    rows.append(np.broadcast_to(r, (E, a, b)).ravel())
    cols.append(np.broadcast_to(c, (E, a, b)).ravel())
    vals.append(np.ascontiguousarray(B, np.float64).ravel())


def _sparse_solve(rows, cols, vals, n_var, b):
    """Solve the assembled symmetric system H x = b (float64, sparse LU)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import splu
    H = coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_var, n_var)).tocsc()
    return splu(H).solve(b)


def _rotation_averaging_host(
    R0: np.ndarray,      # [N, 3, 3] float64 current rotations (world->cam)
    R_meas: np.ndarray,  # [E, 3, 3] measured relative rotations R_j R_i^T
    ii: np.ndarray,      # [E]
    jj: np.ndarray,      # [E]
    sw: np.ndarray,      # [E] sqrt-weight per edge (0 = off)
    free: np.ndarray,    # [N] bool — nodes allowed to move
    rot_sigma: float,
    iters: int,
) -> np.ndarray:
    """Sparse Gauss-Newton/LM rotation averaging on the host in float64.

    Analytic 3x3 blocks: for residual r = log(R_meas^T R_j R_i^T),
    dr/d(dj) = Jr_inv(r) R_rel^T and dr/d(di) = -Jr_inv(r) under left
    perturbations R <- exp(d^) R. The normal equations are a 3Nx3N
    graph-Laplacian-sparse system solved by sparse LU per damped iteration.
    """
    N = R0.shape[0]
    R = R0.copy()
    w_base = (sw / rot_sigma).astype(np.float64)
    on = sw > 0
    rob = np.ones(ii.shape[0])

    def cost_and_parts(R, w_e):
        R_rel = np.einsum("eab,ecb->eac", R[jj], R[ii])      # R_j R_i^T
        A = np.einsum("eba,ebc->eac", R_meas, R_rel)          # R_meas^T R_rel
        r0 = _log_so3_np(A)                                   # [E, 3]
        r = r0 * w_e[:, None]
        return r0, r, R_rel, float(np.sum(r * r))

    def reweight(r0):
        # Geman-McClure-style trimming with a MAD scale: full weight inside
        # 3 MAD-sigmas, quadratic suppression beyond, so that multi-degree
        # essential-matrix estimates at poor baselines cannot steer the
        # sub-degree PnP rotations
        if on.sum() < 4:
            return np.ones_like(rob)
        rn = np.linalg.norm(r0, axis=-1)
        s = 1.4826 * np.median(rn[on]) + 1e-12
        return np.minimum(1.0, (3.0 * s / np.maximum(rn, 1e-12)) ** 2)

    lam = 1e-4
    freen = free.astype(bool)
    eye3 = np.eye(3)
    w_e = w_base
    r0, r, R_rel, cost = cost_and_parts(R, w_e)
    rob = reweight(r0)
    w_e = w_base * np.sqrt(rob)
    r0, r, R_rel, cost = cost_and_parts(R, w_e)
    for _ in range(iters):
        Jri = _jr_inv_np(r0)                                  # [E, 3, 3]
        Jj = w_e[:, None, None] * (Jri @ np.swapaxes(R_rel, -1, -2))
        Ji = -w_e[:, None, None] * Jri
        rows, cols, vals = [], [], []
        _block_triplets(ii, ii, np.einsum("eab,eac->ebc", Ji, Ji),
                        rows, cols, vals)
        _block_triplets(jj, jj, np.einsum("eab,eac->ebc", Jj, Jj),
                        rows, cols, vals)
        Hij = np.einsum("eab,eac->ebc", Ji, Jj)
        _block_triplets(ii, jj, Hij, rows, cols, vals)
        _block_triplets(jj, ii, np.swapaxes(Hij, -1, -2), rows, cols, vals)
        g = np.zeros((N, 3))
        np.add.at(g, ii, np.einsum("eab,ea->eb", Ji, r))
        np.add.at(g, jj, np.einsum("eab,ea->eb", Jj, r))
        # diagonal scale for LM damping + hard prior pinning non-free nodes
        diag = np.zeros(N)
        np.add.at(diag, ii, np.einsum("eab,eab->e", Ji, Ji) / 3.0)
        np.add.at(diag, jj, np.einsum("eab,eab->e", Jj, Jj) / 3.0)
        scale = max(float(diag.max()), 1.0)
        pin = np.where(freen, 0.0, 1e8 * scale)
        for trial in range(4):
            d = (lam * scale) + pin
            nid = np.arange(N)
            _block_triplets(nid, nid, d[:, None, None] * eye3[None],
                            rows, cols, vals)
            dx = _sparse_solve(rows, cols, vals, 3 * N, -g.ravel())
            rows, cols, vals = rows[:-1], cols[:-1], vals[:-1]
            dxn = dx.reshape(N, 3)
            dxn[~freen] = 0.0
            R_new = _exp_so3_np(dxn) @ R
            r0_n, r_n, R_rel_n, cost_n = cost_and_parts(R_new, w_e)
            if cost_n < cost:
                R, r0, r, R_rel, cost = R_new, r0_n, r_n, R_rel_n, cost_n
                lam = max(lam * 0.3, 1e-9)
                # refresh the robust weights at the accepted state
                rob = reweight(r0)
                w_e = w_base * np.sqrt(rob)
                r0, r, R_rel, cost = cost_and_parts(R, w_e)
                break
            lam = min(lam * 10.0, 1e6)
        if cost <= 1e-18:
            break
    return R


@torch.no_grad()
def optimize_pose_graph(
    poses,                    # [N, 4, 4] world->cam
    pose_valid,               # [N]
    pose_fixed,               # [N] gauge anchors (at least one valid)
    pair_idx,                 # [P, 2]
    T_meas,                   # [P, 4, 4] unit-translation relative poses
    weight,                   # [P] measurement confidence (0 = unused)
    iters: int = 12,
    rot_sigma: float = 0.02,   # rad — relative-rotation noise scale
    dir_sigma: float = 0.05,   # unit-vector noise scale
    min_weight: float = 20.0,
    loop_rows=None,            # [Pl] rows with PnP measurements
    T_loop=None,               # [Pl, 4, 4] metric relative SE(3)
    w_loop=None,               # [Pl] PnP inlier counts
    min_loop_weight: float = 30.0,
    local_span: int = 15,
) -> torch.Tensor:
    """Rotation averaging, then camera centres; returns refined poses
    [N, 4, 4] as a tensor in the dtype and on the device of ``poses``.

    Inputs may be tensors on any device or numpy arrays. Residuals per
    edge (i, j): log(R_meas^T R_j R_i^T) / rot_sigma and the direction of
    the centre difference. Translation directions leave the global scale
    free, so the solution is re-scaled about the anchor camera to keep the
    map's scale for the re-triangulation. With ``loop_rows`` / ``T_loop`` /
    ``w_loop`` (from ``loop_pnp_measurements``) those edges carry full
    metric relative SE(3): their rotations replace the essential-matrix
    ones in stage 1, and stage 2 constrains their centre difference as a
    vector. Both stages run in float64 on the host; only the final scale
    restore runs on the poses' device.
    """
    poses_t = poses if isinstance(poses, torch.Tensor) else torch.as_tensor(np.asarray(poses))
    dev, dt = poses_t.device, poses_t.dtype
    N = poses_t.shape[0]
    valid_n = to_numpy(pose_valid).astype(bool)
    fixed_n = to_numpy(pose_fixed).astype(bool)
    pi = to_numpy(pair_idx).astype(np.int64)
    Tm = to_numpy(T_meas).astype(np.float32)
    R_meas = Tm[:, :3, :3].copy()
    weight = to_numpy(weight).astype(np.float32).copy()
    has_loop_pnp = (loop_rows is not None and T_loop is not None and w_loop is not None
                    and len(loop_rows) > 0)
    if has_loop_pnp:
        lrn0 = to_numpy(loop_rows).astype(np.int64)
        wln = to_numpy(w_loop).astype(np.float32)
        Tln = to_numpy(T_loop).astype(np.float32)
        ok_l = (lrn0 >= 0) & (wln >= min_loop_weight)
        # later rows win where a row repeats, as in a scatter
        tgt = np.maximum(lrn0, 0)
        R_meas[tgt[ok_l]] = Tln[ok_l, :3, :3]
        weight[tgt[ok_l]] = np.maximum(weight[tgt[ok_l]], wln[ok_l])
    on = valid_n[pi[:, 0]] & valid_n[pi[:, 1]] & (weight >= min_weight)
    # compact the edge axis to the active rows: the candidate table is
    # mostly dead edges (padding, failed matches)
    keep = np.where(on)[0]
    if keep.size == 0:
        return poses_t
    loop_kept = None
    if has_loop_pnp:
        remap = np.full(pi.shape[0], -1, np.int64)
        remap[keep] = np.arange(keep.shape[0])
        loop_kept = np.where(lrn0 >= 0, remap[np.maximum(lrn0, 0)], -1)
    pi = pi[keep]
    t_meas = Tm[keep, :3, 3]
    R_meas = R_meas[keep]
    sw = np.sqrt(weight[keep])
    sw = sw / np.maximum(np.max(sw), np.float32(1e-9))
    free = valid_n & ~fixed_n
    iin, jjn = pi[:, 0], pi[:, 1]
    P_np = to_numpy(poses_t).astype(np.float32)
    R0 = P_np[:, :3, :3]

    # ---- stage 1: rotation averaging (sparse GN/LM over SO(3)^N, host) ------
    R_new64 = _rotation_averaging_host(
        np.asarray(R0, np.float64), np.asarray(R_meas, np.float64),
        iin, jjn, np.asarray(sw, np.float64), free, rot_sigma, iters)

    # ---- stage 2: camera centers and scales (linear, host float64) ----------
    c0 = -torch.einsum("nij,ni->nj", poses_t[:, :3, :3], poses_t[:, :3, 3])
    c0n = to_numpy(c0).astype(np.float64)
    R64 = R_new64
    R_old64 = np.asarray(R0, np.float64)
    t64 = np.asarray(t_meas, np.float64)
    t64 /= np.maximum(np.linalg.norm(t64, axis=-1, keepdims=True), 1e-12)
    dn = np.einsum("pji,pj->pi", R64[jjn], t64)           # R_j^T t_meas
    w2 = np.asarray(sw, np.float64) ** 2

    # per-camera scale variables sigma_i: short-range edges constrain
    # (c_i - c_j) = sigma_i * m_e * d_e (locally rigid shape, smoothly
    # re-scalable along the trajectory), long-range (loop) edges add
    # direction-only projector terms; jointly linear in (c, sigma)
    span = np.abs(jjn - iin)
    local = span <= local_span
    # PnP loop edges: full metric center-difference vectors in the loop
    # start's local map scale, coupled to sigma_i like the local vectors
    P_edges = iin.shape[0]
    has_pnp = np.zeros(P_edges, bool)
    v_pnp = np.zeros((P_edges, 3))
    if has_loop_pnp:
        lrn = loop_kept
        Tln = np.asarray(Tln, np.float64)
        sel = (lrn >= 0) & (wln >= min_loop_weight)
        rows = lrn[sel]
        # center of cam_j in cam_i coordinates: c_j^(i) = -R_rel^T t_rel,
        # then to world through the CORRECTED rotation of i
        cji = -np.einsum("pji,pj->pi", Tln[sel, :3, :3], Tln[sel, :3, 3])
        has_pnp[rows] = True
        v_pnp[rows] = np.einsum("pji,pj->pi", R64[iin[rows]], cji)
    # trust the measured directions of local edges only when they agree
    # tightly with the reconstruction's local displacements; otherwise use
    # the reconstruction's locally rigid shape through the corrected
    # rotations (loop edges keep the measured directions either way)
    d_cur = c0n[iin] - c0n[jjn]
    d_cur /= np.maximum(np.linalg.norm(d_cur, axis=-1, keepdims=True), 1e-12)
    cos_md = np.clip(np.sum(d_cur * dn, axis=-1), -1.0, 1.0)
    th_loc = np.arccos(cos_md)[local & (w2 > 0)]
    theta_med = float(np.median(th_loc)) if th_loc.size else 0.2
    use_meas = theta_med < np.deg2rad(3.0)
    if not use_meas:
        u_cam = np.einsum("pij,pj->pi", R_old64[jjn], c0n[iin] - c0n[jjn])
        d_local = np.einsum("pji,pj->pi", R64[jjn], u_cam)
        d_local /= np.maximum(
            np.linalg.norm(d_local, axis=-1, keepdims=True), 1e-12)
        dn = np.where(local[:, None], d_local, dn)
    eye3 = np.eye(3)
    n_var = 3 * N + N
    freen = free

    cn_cur = c0n
    sg_cur = np.ones(N)

    # IRLS with per-class MAD scales (metric PnP vectors, local vectors,
    # direction-only edges)
    def _trim(r_all, vec, rest):
        rob = np.ones(P_edges)
        for cls in (vec & has_pnp, vec & ~has_pnp, rest):
            cls = cls & (w2 > 0)
            if cls.sum() >= 4:
                s_ = 1.4826 * np.median(np.abs(r_all[cls])) + 1e-12
                rob[cls] = np.minimum(
                    1.0, (3.0 * s_ / np.maximum(r_all[cls], 1e-12)) ** 2)
        return rob

    def _residuals(cn, sg, m_e, vec, rest):
        r_all = np.zeros(P_edges)
        dvec = cn[iin] - cn[jjn]
        lv_all = np.where(has_pnp[:, None], -v_pnp, m_e[:, None] * dn)
        r_all[vec] = np.linalg.norm(
            dvec[vec] - sg[iin[vec], None] * lv_all[vec], axis=-1)
        Pp = np.eye(3)[None] - dn[:, :, None] * dn[:, None, :]
        r_all[rest] = np.linalg.norm(
            np.einsum("eab,eb->ea", Pp[rest], dvec[rest]), axis=-1)
        return r_all

    # pre-trim at the initial configuration: the current poses are locally
    # right, so a garbage metric vector already sticks out against them
    vec0 = local | has_pnp
    m_e0 = np.linalg.norm(c0n[iin] - c0n[jjn], axis=-1)
    rob = _trim(_residuals(c0n, np.ones(N), m_e0, vec0, ~vec0), vec0, ~vec0)
    for _pass in range(3):
        m_e = np.linalg.norm(cn_cur[iin] - cn_cur[jjn], axis=-1) \
            if use_meas else np.linalg.norm(c0n[iin] - c0n[jjn], axis=-1)
        # per-constraint noise models: local vectors are tight (~2% of
        # their baseline), measured directions noisy; sigmas floored at a
        # fraction of the median baseline
        m_med = max(np.median(m_e[local]) if local.any() else 1.0, 1e-6)
        sig_local = 0.02 * np.maximum(m_e, 0.1 * m_med)
        dir_coef = float(np.clip(3.0 * theta_med, 0.03, 0.25))
        sig_dir = dir_coef * np.maximum(m_e, m_med)
        w_local = (w2 > 0) / (sig_local ** 2)
        w_dir = (w2 > 0) / (sig_dir ** 2)
        # the PnP center error scales with the local map depth, not with
        # the edge baseline: floor at half the median local baseline
        sig_pnp = 0.05 * np.maximum(np.linalg.norm(v_pnp, axis=-1),
                                    0.5 * m_med)
        w_pnp = (w2 > 0) / (sig_pnp ** 2)
        vec = local | has_pnp
        li = iin[vec]
        lj = jjn[vec]
        lw = np.where(has_pnp[vec], w_pnp[vec], w_local[vec]) * rob[vec]
        lv = np.where(has_pnp[vec, None], -v_pnp[vec],
                      m_e[vec, None] * dn[vec])            # [El, 3]
        rows, cols, vals = [], [], []
        wI = lw[:, None, None] * eye3[None]                # [El, 3, 3]
        _block_triplets(li, li, wI, rows, cols, vals)
        _block_triplets(lj, lj, wI, rows, cols, vals)
        _block_triplets(li, lj, -wI, rows, cols, vals)
        _block_triplets(lj, li, -wI, rows, cols, vals)
        wv = (lw[:, None] * lv)[:, :, None]                # [El, 3, 1]
        sig_kw = dict(stride_c=1, off_c=3 * N)
        sig_kw_t = dict(stride_r=1, off_r=3 * N)
        _block_triplets(li, li, -wv, rows, cols, vals, **sig_kw)
        _block_triplets(li, li, -np.swapaxes(wv, 1, 2), rows, cols, vals,
                        **sig_kw_t)
        _block_triplets(lj, li, wv, rows, cols, vals, **sig_kw)
        _block_triplets(li, lj, np.swapaxes(wv, 1, 2), rows, cols, vals,
                        **sig_kw_t)
        ws = (lw * np.einsum("ea,ea->e", lv, lv))[:, None, None]
        _block_triplets(li, li, ws, rows, cols, vals,
                        stride_r=1, stride_c=1, off_r=3 * N, off_c=3 * N)
        # remaining loop edges (no PnP): direction projector on (c_i - c_j)
        Pproj = eye3[None] - dn[:, :, None] * dn[:, None, :]
        rest = ~vec
        gi = iin[rest]
        gj = jjn[rest]
        gP = Pproj[rest] * (w_dir[rest] * rob[rest])[:, None, None]
        _block_triplets(gi, gi, gP, rows, cols, vals)
        _block_triplets(gj, gj, gP, rows, cols, vals)
        _block_triplets(gi, gj, -gP, rows, cols, vals)
        _block_triplets(gj, gi, -gP, rows, cols, vals)
        # priors: anchor fixed/invalid centers hard, free weakly; sigma -> 1
        # (hard on the anchor, weak everywhere to bound unobserved scales)
        b = np.zeros(n_var)
        wmax = max(np.median(w_local[local & (w2 > 0)])
                   if (local & (w2 > 0)).any() else 1.0, 1.0)
        prior_c = np.where(freen, 1e-8 * wmax, 1e3 * wmax)
        nid = np.arange(N)
        _block_triplets(nid, nid, prior_c[:, None, None] * eye3[None],
                        rows, cols, vals)
        b[:3 * N] += (prior_c[:, None] * c0n).ravel()
        prior_s = np.where(freen, 1e-6 * wmax, 1e3 * wmax)
        _block_triplets(nid, nid, prior_s[:, None, None], rows, cols, vals,
                        stride_r=1, stride_c=1, off_r=3 * N, off_c=3 * N)
        b[3 * N:] += prior_s * 1.0
        sol = _sparse_solve(rows, cols, vals, n_var, b)
        cn_cur = sol[:3 * N].reshape(N, 3)
        sg_cur = sol[3 * N:]
        # robust multipliers for the next pass, floored by the pre-trim
        rob = np.minimum(
            rob, _trim(_residuals(cn_cur, sg_cur, m_e, vec, rest),
                       vec, rest))

    # ---- restore the original map scale about the anchor camera -------------
    R_new = torch.as_tensor(R_new64, device=dev).to(dt)
    c_new = torch.as_tensor(cn_cur, device=dev).to(dt)
    valid_t = torch.as_tensor(valid_n, device=dev)
    free_t = torch.as_tensor(free, device=dev)
    anchor = int(np.argmax(fixed_n & valid_n))
    d0 = torch.where(valid_t, torch.linalg.vector_norm(c0 - c0[anchor], dim=-1), 0.0)
    d1 = torch.where(valid_t, torch.linalg.vector_norm(c_new - c_new[anchor], dim=-1), 0.0)
    s = (d0 * d1).sum() / torch.clamp((d1 * d1).sum(), min=1e-9)
    c_new = c_new[anchor] + s * (c_new - c_new[anchor])
    c_new = torch.where(free_t[:, None], c_new, c0)
    T_out = torch.zeros_like(poses_t)
    T_out[:, :3, :3] = R_new
    T_out[:, :3, 3] = -torch.einsum("nij,nj->ni", R_new, c_new)
    T_out[:, 3, 3] = 1.0
    return torch.where(valid_t[:, None, None], T_out, poses_t)


def loop_consistency(
    poses,          # [N, 4, 4]
    pair_idx,       # [P, 2]
    loop_rows,      # [Pl]
    T_loop,         # [Pl, 4, 4] metric PnP measurements
    w_loop,         # [Pl]
    min_weight: float = 30.0,
) -> float:
    """Mean deviation (degrees) of the loop PnP measurements from the
    relative poses implied by ``poses``: rotation angle plus
    translation-direction angle, the latter weighted by the measured
    baseline relative to the median (at a near-coincident revisit the angle
    between two almost-zero vectors means nothing). Tensors or arrays.

    The pipeline applies a pose-graph correction only if this number
    improves substantially. Returns +inf when no loop edge passes the
    weight gate.
    """
    lrn = to_numpy(loop_rows)
    wln = to_numpy(w_loop)
    sel = (lrn >= 0) & (wln >= min_weight)
    if not sel.any():
        return float("inf")
    rows = lrn[sel]
    Tl = to_numpy(T_loop).astype(np.float64)[sel]
    T = to_numpy(poses).astype(np.float64)
    pi = to_numpy(pair_idx)
    i, j = pi[rows, 0], pi[rows, 1]
    Ri = T[i, :3, :3]
    rel = np.einsum("pab,pcb->pac", T[j, :3, :3], Ri)        # R_j R_i^T
    # rotation residual
    Rr = np.einsum("pab,pcb->pac", rel, Tl[:, :3, :3])
    cosr = np.clip((np.trace(Rr, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    rot_deg = np.degrees(np.arccos(cosr))
    # translation-direction residual (c_j in cam_i frame), weighted by the
    # measured baseline
    a = np.einsum("pab,pb->pa", Ri, centers_of(T)[j] - centers_of(T)[i])
    b = -np.einsum("pba,pb->pa", Tl[:, :3, :3], Tl[:, :3, 3])
    an = np.linalg.norm(a, axis=1)
    bn = np.linalg.norm(b, axis=1)
    ok = (an > 1e-9) & (bn > 1e-9)
    dir_deg = np.zeros(len(rows))
    dir_deg[ok] = np.degrees(np.arccos(np.clip(
        (a[ok] * b[ok]).sum(1) / (an[ok] * bn[ok]), -1.0, 1.0)))
    b_ref = max(float(np.median(bn)), 1e-9)
    dir_w = np.minimum(bn / b_ref, 1.0)
    ww = wln[sel]
    return float(np.sum(ww * (rot_deg + dir_w * dir_deg)) / np.sum(ww))


def centers_of(T) -> np.ndarray:
    """Camera centers of world->cam matrices (host-side helper)."""
    T = to_numpy(T)
    return -np.einsum("nij,ni->nj", T[:, :3, :3], T[:, :3, 3])


@torch.no_grad()
def rebuild_map(
    scene: Scene,
    fp_tbl: torch.Tensor,   # [N, D] frame_pair_table
    max_repr_error: float,
    min_tri_angle: float,
    max_observers: int = 12,
    segment: int = 128,
) -> Scene:
    """Wipe the landmark table and re-run the merge/triangulation pass for
    every registered frame, in frame order, under the (corrected) poses.

    Links that drift previously forced apart, in particular every loop
    closure, now pass the reprojection gates and connect into long tracks.
    Frames with an invalid pose are skipped: the pass would force that pose
    in as a self-observer and merge-link keypoints under a garbage
    reprojection. ``segment`` bounds the size of the reference's compiled
    program and has no effect here: the frames run in one host loop.
    """
    N, K = scene.kp_mask.shape
    scene = scene._replace(
        kp2lm=torch.full((N, K), -1, dtype=torch.int32, device=scene.kp2lm.device),
        lm_valid=torch.zeros_like(scene.lm_valid),
        lm_two_view=torch.zeros_like(scene.lm_two_view),
        points=torch.zeros_like(scene.points),
        n_landmarks=torch.zeros_like(scene.n_landmarks),
    )
    for f in np.flatnonzero(scene.pose_valid.cpu().numpy()):
        scene, _, _ = triangulate_frame(scene, int(f), fp_tbl[f], 2, max_repr_error,
                                        min_tri_angle, max_observers=max_observers)
    return scene
