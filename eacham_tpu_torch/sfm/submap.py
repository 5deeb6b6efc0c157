"""Hierarchical submap alignment: drift control for long trajectories
(port of eacham_tpu/sfm/submap.py; host numpy, unchanged; the
measurements quoted are the JAX package's).

The frame-level pose graph (posegraph.py) linearizes residuals around the
current poses; when accumulated sweep drift reaches tens of degrees of
loop inconsistency (measured: 39.5 deg at N=1000, SCALING.md) the
correction it can express is dwarfed by the error and its consistency
gate correctly refuses to act. The SLAM-standard fix is hierarchy:

  1. ``split_submaps``: partition the trajectory into contiguous cores
     (~1 window-BA horizon each). Window BA keeps each core internally
     rigid — the measured scale profile of the 500/1000-frame stresses
     shows drift lives BETWEEN regions, not inside them.
  2. ``submap_align``: treat each submap as one rigid body with an
     unknown Sim(3) correction. Seam edges pin consecutive submaps to
     their current relative arrangement (drift across one seam is
     negligible); metric loop-PnP edges (posegraph.loop_pnp_measurements)
     pull revisits together. Rotation averaging over the few dozen
     submap nodes followed by one linear center+scale solve — both the
     float64 sparse host solvers of posegraph.py — converges from
     arbitrary loop-sized errors because each node moves RIGIDLY: the
     per-node correction is large but the graph is tiny and the rotation
     stage re-linearizes.
  3. Corrections are applied per frame with geodesic blending across
     seam bands so no kink survives into the frame-level PGO, which then
     runs on a small-residual problem it CAN linearize, followed by
     ``rebuild_map`` + global BA as before.

No reference counterpart (fatlipp/eacham has no loop handling at all);
the closest reference stage is its global BA (apps/sfm/main.cpp:228-231),
which assumes drift-free registration.
"""

from __future__ import annotations

import numpy as np

from eacham_tpu_torch.sfm.posegraph import (
    _block_triplets,
    _exp_so3_np,
    _log_so3_np,
    _rotation_averaging_host,
    _sparse_solve,
)


def _centers_np(T: np.ndarray) -> np.ndarray:
    return -np.einsum("nij,ni->nj", T[:, :3, :3], T[:, :3, 3])


def split_submaps(
    pose_valid: np.ndarray, size: int = 100,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition frames into contiguous cores of ~``size`` frames.

    Returns ``(member [N] int32 submap id, rep [S] int32 representative
    frame per submap, ok [S] bool — submap has any valid frame)``. The
    representative is the middle VALID frame of each core (identity
    fallback otherwise; such submaps ride along unconstrained and their
    frames pass through unchanged).
    """
    N = pose_valid.shape[0]
    S = max(1, int(np.ceil(N / size)))
    bounds = np.linspace(0, N, S + 1).astype(np.int64)
    member = np.zeros(N, np.int32)
    rep = np.zeros(S, np.int32)
    ok = np.zeros(S, bool)
    for s in range(S):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        member[lo:hi] = s
        valid_idx = np.where(pose_valid[lo:hi])[0]
        if valid_idx.size:
            rep[s] = lo + int(valid_idx[np.argmin(
                np.abs(valid_idx - (hi - lo) / 2))])
            ok[s] = True
    return member, rep, ok


def submap_align(
    poses: np.ndarray,       # [N, 4, 4] world->cam (host)
    pose_valid: np.ndarray,  # [N]
    pose_fixed: np.ndarray,  # [N]
    pair_idx: np.ndarray,    # [P, 2]
    loop_rows: np.ndarray,   # [Pl] rows into pair axis (-1 pad)
    T_loop: np.ndarray,      # [Pl, 4, 4] metric PnP relative measurements
    w_loop: np.ndarray,      # [Pl] PnP inlier counts
    size: int = 100,
    min_loop_weight: float = 30.0,
    rot_iters: int = 30,
    blend: int = 20,
) -> np.ndarray:
    """Rigid-submap Sim(3) alignment; returns corrected poses [N, 4, 4].

    Edge reduction: a metric measurement M between frames a (submap s)
    and b (submap s') constrains the corrected representative poses via
    ``Q'_{s'} Q'_s^{-1} = B_b^{-1} M A_a`` with the within-submap offsets
    ``A_a = T_a Q_s^{-1}``, ``B_b = T_b Q_{s'}^{-1}`` held rigid (they
    come from the current reconstruction, accurate at submap span).
    Consecutive submaps get a seam edge whose measurement is the current
    rep relative itself (zero initial residual — seams only distribute
    the loop corrections). The loop-PnP translation lives in the loop
    START's local scale, so it couples to the per-submap scale variable
    exactly like posegraph stage 2's sigma field.
    """
    N = poses.shape[0]
    poses64 = np.asarray(poses, np.float64)
    member, rep, sub_ok = split_submaps(np.asarray(pose_valid), size)
    S = rep.shape[0]
    if S < 2:
        return np.asarray(poses)

    Q = poses64[rep]                                     # [S, 4, 4]
    Rq = Q[:, :3, :3]
    cq = _centers_np(Q)

    # ---- edge list over submap nodes ------------------------------------
    e_i, e_j, e_R, e_v, e_loop = [], [], [], [], []
    # seam edges between consecutive OK submaps: measurement = current rel
    prev = None
    for s in range(S):
        if not sub_ok[s]:
            continue
        if prev is not None:
            rel = Q[s] @ np.linalg.inv(Q[prev])
            e_i.append(prev)
            e_j.append(s)
            e_R.append(rel[:3, :3])
            # center of rep_s in rep_prev's camera frame
            e_v.append(-rel[:3, :3].T @ rel[:3, 3])
            e_loop.append(False)
        prev = s
    # loop edges: reduce the frame-level PnP measurements to rep pairs
    lrn = np.asarray(loop_rows)
    wln = np.asarray(w_loop)
    pin = np.asarray(pair_idx)
    Tl = np.asarray(T_loop, np.float64)
    sel = np.where((lrn >= 0) & (wln >= min_loop_weight))[0]
    for k in sel:
        a, b = int(pin[lrn[k], 0]), int(pin[lrn[k], 1])
        sa, sb = int(member[a]), int(member[b])
        if sa == sb or not (sub_ok[sa] and sub_ok[sb]):
            continue
        if not (pose_valid[a] and pose_valid[b]):
            continue
        A = poses64[a] @ np.linalg.inv(Q[sa])
        B = poses64[b] @ np.linalg.inv(Q[sb])
        Z = np.linalg.inv(B) @ Tl[k] @ A
        e_i.append(sa)
        e_j.append(sb)
        e_R.append(Z[:3, :3])
        e_v.append(-Z[:3, :3].T @ Z[:3, 3])
        e_loop.append(True)
    if not any(e_loop):
        return np.asarray(poses)                      # nothing to correct

    ii = np.asarray(e_i, np.int64)
    jj = np.asarray(e_j, np.int64)
    R_meas = np.stack(e_R)
    v_meas = np.stack(e_v)                            # [E, 3] cam-i coords
    is_loop = np.asarray(e_loop)

    # anchor: the submap holding a fixed valid frame (else the first OK one)
    fx = np.where(np.asarray(pose_fixed) & np.asarray(pose_valid))[0]
    anchor = int(member[fx[0]]) if fx.size else int(np.argmax(sub_ok))
    free = sub_ok.copy()
    free[anchor] = False

    # ---- stage 1: rotation averaging over submap nodes -------------------
    # loops weighted above seams: a seam edge encodes the DRIFTED
    # arrangement (its uncertainty is exactly the per-submap-span drift
    # being corrected), while the loop-PnP measurement is accurate to
    # local reprojection noise. The least-squares balance then absorbs
    # the correction smoothly across the seams (measured on the 600-frame
    # test: seams-above-loops left 4.8 deg of loop residual; this
    # weighting leaves the loops sub-degree).
    sw = np.where(is_loop, 3.0, 1.0)
    R_new = _rotation_averaging_host(
        Rq.copy(), R_meas, ii, jj, sw, free, rot_sigma=0.02,
        iters=rot_iters)

    # ---- stage 2: linear center + per-submap-scale solve -----------------
    # residual per edge: (c'_j - c'_i) - sigma_i * u_e with
    # u_e = R'_i^T v_meas (v in cam-i coords, through the CORRECTED
    # rotation of i so the heading fix integrates into the positions)
    u = np.einsum("eba,eb->ea", R_new[ii], v_meas)     # [E, 3]
    base = np.linalg.norm(u, axis=-1)
    b_med = max(float(np.median(base[~is_loop])) if (~is_loop).any()
                else 1.0, 1e-9)
    # same stance as stage 1: loops stiff (PnP-accurate; rep-to-rep loop
    # baselines span >= a submap so no near-coincident noise directions),
    # seams soft (their error IS the drift)
    sig = np.where(is_loop, 0.02 * np.maximum(base, 0.25 * b_med),
                   0.05 * np.maximum(base, 0.1 * b_med))
    w_e0 = 1.0 / sig ** 2
    n_var = 3 * S + S
    eye3 = np.eye(3)
    E = ii.shape[0]

    # robust trimming: near-coincident revisit vectors carry PnP noise
    # several times their true length (measured 4-8x on the fs6 dump);
    # MAD-thresholded suppression drops them without touching clean edges
    def _trim(r_e):
        rob = np.ones(E)
        for cls in (is_loop, ~is_loop):
            if cls.sum() >= 4:
                s = 1.4826 * np.median(r_e[cls]) + 1e-12
                rob[cls] = np.minimum(
                    1.0, (3.0 * s / np.maximum(r_e[cls], 1e-12)) ** 2)
        return rob

    # pre-trim at the initial configuration (garbage vectors already
    # stick out against the locally-correct current arrangement)
    rob = _trim(np.linalg.norm((cq[jj] - cq[ii]) - u, axis=-1))
    for _pass in range(3):
        w_e = w_e0 * rob
        rows, cols, vals = [], [], []
        wI = w_e[:, None, None] * eye3[None]
        _block_triplets(ii, ii, wI, rows, cols, vals)
        _block_triplets(jj, jj, wI, rows, cols, vals)
        _block_triplets(ii, jj, -wI, rows, cols, vals)
        _block_triplets(jj, ii, -wI, rows, cols, vals)
        # coupling blocks for residual (c'_j - c'_i) - sigma_i u:
        # dr/dc_i = -I, dr/dc_j = +I, dr/dsigma_i = -u
        wv = (w_e[:, None] * u)[:, :, None]
        _block_triplets(ii, ii, wv, rows, cols, vals, stride_c=1,
                        off_c=3 * S)
        _block_triplets(ii, ii, np.swapaxes(wv, 1, 2), rows, cols, vals,
                        stride_r=1, off_r=3 * S)
        _block_triplets(jj, ii, -wv, rows, cols, vals, stride_c=1,
                        off_c=3 * S)
        _block_triplets(ii, jj, -np.swapaxes(wv, 1, 2), rows, cols, vals,
                        stride_r=1, off_r=3 * S)
        ws = (w_e * np.einsum("ea,ea->e", u, u))[:, None, None]
        _block_triplets(ii, ii, ws, rows, cols, vals,
                        stride_r=1, stride_c=1, off_r=3 * S, off_c=3 * S)
        b = np.zeros(n_var)
        wmax = max(float(np.median(w_e)), 1.0)
        prior_c = np.where(free, 1e-8 * wmax, 1e4 * wmax)
        sid = np.arange(S)
        _block_triplets(sid, sid, prior_c[:, None, None] * eye3[None],
                        rows, cols, vals)
        b[:3 * S] += (prior_c[:, None] * cq).ravel()
        prior_s = np.where(free, 1e-6 * wmax, 1e4 * wmax)
        _block_triplets(sid, sid, prior_s[:, None, None], rows, cols, vals,
                        stride_r=1, stride_c=1, off_r=3 * S, off_c=3 * S)
        b[3 * S:] += prior_s * 1.0
        sol = _sparse_solve(rows, cols, vals, n_var, b)
        c_new = sol[:3 * S].reshape(S, 3)
        sig_s = sol[3 * S:]
        r_e = np.linalg.norm(
            (c_new[jj] - c_new[ii]) - sig_s[ii, None] * u, axis=-1)
        # floored by the pre-trim so dragged solutions cannot resurrect
        # the garbage they were dragged by
        rob = np.minimum(rob, _trim(r_e))
    sigma = np.clip(sig_s, 0.2, 5.0)

    # ---- apply per-submap world similarity with seam blending ------------
    # world map of submap s: x' = sigma_s R_w x + t_w, derived from the
    # rep correction: R_w = R'_rep^T R_rep, c'_n = sigma R_w (c_n - c_rep)
    # + c'_rep; camera rotation R'_n = R_n R_w^T.
    R_w = np.einsum("sba,sbc->sac", R_new, Rq)          # R'_rep^T R_rep
    c_all = _centers_np(poses64)
    R_all = poses64[:, :3, :3]

    def corrected(n, s):
        Rw = R_w[s]
        cn = sigma[s] * (Rw @ (c_all[n] - cq[s])) + c_new[s]
        Rn = R_all[n] @ Rw.T
        return Rn, cn

    out = poses64.copy()
    bounds = np.where(np.diff(member))[0] + 1           # seam frame indices
    for n in range(N):
        if not pose_valid[n]:
            continue
        s = int(member[n])
        if not sub_ok[s]:
            continue
        Rn, cn = corrected(n, s)
        # geodesic blend across the seam band into the neighbor submap
        if blend > 0:
            for sb_ in bounds:
                d = n - sb_                              # <0: before seam
                if -blend <= d < blend:
                    other = int(member[sb_]) if d < 0 else int(
                        member[sb_ - 1])
                    if other != s and 0 <= other < S and sub_ok[other]:
                        lam = 0.5 * (1.0 - abs(d + 0.5) / blend)
                        Ro, co = corrected(n, other)
                        cn = (1.0 - lam) * cn + lam * co
                        dR = _log_so3_np((Ro @ Rn.T)[None])[0]
                        Rn = _exp_so3_np((lam * dR)[None])[0] @ Rn
                    break
        out[n, :3, :3] = Rn
        out[n, :3, 3] = -Rn @ cn
    # preserve the fixed-frame gauge exactly: re-anchor by the fixed
    # frame's original pose (the anchor submap is pinned, but blending
    # and float rounding may graze it)
    if fx.size:
        f0 = int(fx[0])
        # world-side (right) gauge fix: preserves every relative pose
        fix = np.linalg.inv(out[f0]) @ poses64[f0]
        out = np.einsum("nab,bc->nac", out, fix)
    out[~np.asarray(pose_valid)] = poses64[~np.asarray(pose_valid)]
    return out.astype(np.asarray(poses).dtype)
