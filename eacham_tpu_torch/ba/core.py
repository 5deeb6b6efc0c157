"""Bundle adjustment: batched Levenberg-Marquardt (or Powell dogleg) with a
Schur complement over the landmark blocks (port of eacham_tpu/ba/core.py).

The factor structure is the reference's:

  * reprojection factors, Huber 3.0 on a 1.5 px isotropic noise, as
    whitened residual arrays with IRLS weights;
  * per-pose Huber(2.5) priors anchored at the initial poses (sigma 45 deg,
    0.35); gauge-fixed cameras are hard-masked, not given a tight prior;
  * per-landmark priors anchored at the initial points, sigma 1 / observers;
  * a shared (fx, fy) block with a prior of sigma 25; principal point fixed;
  * optional absolute pose anchors (GPS priors, surveyed cameras): tight,
    un-robustified se(3) priors that replace the weak priors when present.

The landmark blocks are eliminated in closed form (batched 3x3 inverses).
The reduced camera system S = U - W V^-1 W^T is either materialized and
solved directly (``solver="dense"``: Jacobi CG on the matrix, or Cholesky)
or never formed and applied matrix-free inside a block-Jacobi PCG
(``solver="pcg"``).

Layout. Every per-observation quantity is written once, with the
observation axis first: residuals [O, 2], Jacobians [O, 2, 6] / [O, 2, 3] /
[O, 2, 2]. (The reference keeps a second, transposed copy of every such
function and chunks its segment sums, both for the TPU's (8, 128) tiling of
minor dimensions; neither concerns this card.) Segment sums over cameras
and landmarks are ``index_add_``: float atomics on the card, so sums differ
from run to run in their last bits.

Everything is fp32 (TF32 off, see ``eacham_tpu_torch.fp``). The LM loop is a
host loop; its state stays on the device, the accept step is a
``torch.where``, and the host reads one flag per iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from eacham_tpu_torch.geometry.linalg import inv3x3
from eacham_tpu_torch.geometry.se3 import exp_se3, inverse_se3, log_se3

_EPS = 1e-12

# noise model constants (the reference's, from its C++ ancestor)
PX_SIGMA = 1.5            # isotropic pixel sigma
PX_HUBER = 3.0            # Huber k on the whitened pixel error
POSE_SIGMA_ROT = 45.0 * math.pi / 180.0
POSE_SIGMA_POS = 0.35
POSE_HUBER = 2.5
K_SIGMA = 25.0            # fx, fy prior sigma


class BAProblem(NamedTuple):
    """Struct-of-arrays bundle-adjustment problem (padded + masked)."""

    poses: torch.Tensor       # [N, 4, 4] world->cam
    points: torch.Tensor      # [L, 3]
    intr: torch.Tensor        # [4] fx fy cx cy (shared camera)
    obs_cam: torch.Tensor     # [O] int64
    obs_pt: torch.Tensor      # [O] int64
    obs_uv: torch.Tensor      # [O, 2] pixels
    obs_mask: torch.Tensor    # [O] bool
    cam_in_ba: torch.Tensor   # [N] bool — cameras being optimized
    cam_fixed: torch.Tensor   # [N] bool — gauge-fixed cameras (zero update)
    pt_in_ba: torch.Tensor    # [L] bool — landmarks being optimized
    pt_obs_count: torch.Tensor  # [L] float — total observers (for the prior)
    # optional absolute pose references: tight se(3) anchors to externally
    # known poses; None = none (the default)
    abs_pose: torch.Tensor | None = None   # [N, 4, 4] world->cam anchors
    abs_mask: torch.Tensor | None = None   # [N] bool — which cams are anchored


class BAConfig(NamedTuple):
    max_iters: int = 50
    tolerance: float = 1e-5       # relative cost-decrease stop
    cg_iters: int = 30
    cg_tol: float = 1e-6
    lambda_init: float = 1e-4
    lambda_min: float = 1e-10
    lambda_max: float = 1e8
    use_pose_priors: bool = True
    use_point_priors: bool = True
    # "pcg": implicit Schur + block-Jacobi PCG (any L).
    # "dense": materialize the reduced [6N + 2] camera system.
    # "auto": the reference's rule, kept so that both packages take the same
    # solver on the same problem: dense when L * N * 8 * 128 * 4 bytes (the
    # W blocks as a TPU would tile them) stay under dense_budget_bytes. On
    # this card it is a rule kept for parity, not a memory limit.
    solver: str = "auto"
    dense_budget_bytes: int = 1_342_177_280
    # dense path: > 0 = Jacobi-CG iterations on the materialized system,
    # 0 = Cholesky
    dense_cg_iters: int = 64
    method: str = "lm"            # "lm" or "dogleg"
    trust_radius_init: float = 1.0
    # absolute-anchor noise (used only when BAProblem.abs_pose is set)
    abs_sigma_rot: float = 0.01
    abs_sigma_pos: float = 0.01


def _huber_sqrt_weight(r_norm: torch.Tensor, k) -> torch.Tensor:
    """sqrt of the IRLS weight of a Huber M-estimator on a whitened norm."""
    return torch.sqrt(torch.clamp(k / torch.clamp(r_norm, min=_EPS), max=1.0))


def _camera_points(poses, points, p: BAProblem):
    """Each observation's landmark in its camera's frame, [O, 3]."""
    T = poses[p.obs_cam]
    R = T[:, :3, :3]
    return R, torch.einsum("oij,oj->oi", R, points[p.obs_pt]) + T[:, :3, 3]


def _obs_linearize(poses, points, intr, p: BAProblem):
    """Per-observation whitened, robustified residuals and Jacobians:
    r [O, 2], Jc [O, 2, 6], Jp [O, 2, 3], Jk [O, 2, 2]."""
    R, pc = _camera_points(poses, points, p)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    good = p.obs_mask & p.cam_in_ba[p.obs_cam] & p.pt_in_ba[p.obs_pt] & (z > 1e-4)
    inv_z = 1.0 / torch.where(z > 1e-4, z, 1.0)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    r = torch.stack([fx * x * inv_z + cx, fy * y * inv_z + cy], -1) - p.obs_uv

    r_w = r / PX_SIGMA
    w = _huber_sqrt_weight(torch.linalg.vector_norm(r_w, dim=-1), PX_HUBER)
    w = torch.where(good, w, 0.0)

    zeros = torch.zeros_like(z)
    ones = torch.ones_like(z)
    J_pc = torch.stack([
        torch.stack([fx * inv_z, zeros, -fx * x * inv_z * inv_z], -1),
        torch.stack([zeros, fy * inv_z, -fy * y * inv_z * inv_z], -1),
    ], -2)                                                     # [O, 2, 3]
    # left perturbation of the pose: dpc/d(omega, v) = [-[pc]_x | I]
    dpc_dxi = torch.stack([
        torch.stack([zeros, z, -y, ones, zeros, zeros], -1),
        torch.stack([-z, zeros, x, zeros, ones, zeros], -1),
        torch.stack([y, -x, zeros, zeros, zeros, ones], -1),
    ], -2)                                                     # [O, 3, 6]
    scale = (w / PX_SIGMA)[:, None, None]
    Jc = (J_pc @ dpc_dxi) * scale
    Jp = (J_pc @ R) * scale
    Jk = torch.stack([
        torch.stack([x * inv_z, zeros], -1),
        torch.stack([zeros, y * inv_z], -1),
    ], -2) * scale                                             # d(u, v)/d(fx, fy)
    return r_w * w[:, None], Jc, Jp, Jk


def _sigmas(rot: float, pos: float, like: torch.Tensor) -> torch.Tensor:
    """[6] sigmas (rotation x 3, position x 3), made on the device."""
    return torch.cat([like.new_full((3,), rot), like.new_full((3,), pos)])


def _prior_terms(poses, points, intr, p: BAProblem, anchors, cfg: BAConfig):
    """Whitened anchored-prior residuals and (diagonal) Jacobian scales.

    Pose prior: r = Log(T T0^-1) / sigma with Huber(2.5) IRLS; the Jacobian
    with respect to the left-multiplied twist is taken as I (exact at
    r = 0, usual for weak priors). Fixed cameras are hard-masked.
    """
    poses0, points0, intr0 = anchors
    sig_pose = _sigmas(POSE_SIGMA_ROT, POSE_SIGMA_POS, poses)
    r_pose = log_se3(poses @ inverse_se3(poses0)) / sig_pose          # [N, 6]
    w_pose = _huber_sqrt_weight(torch.linalg.vector_norm(r_pose, dim=-1), POSE_HUBER)
    pose_on = p.cam_in_ba & (~p.cam_fixed)
    if not cfg.use_pose_priors:
        pose_on = torch.zeros_like(pose_on)
    w_pose = torch.where(pose_on, w_pose, 0.0)
    r_pose = r_pose * w_pose[:, None]
    j_pose = w_pose[:, None] / sig_pose                                    # [N, 6]

    n_obs = torch.clamp(p.pt_obs_count, min=1.0)
    sig_pt = 1.0 / n_obs
    r_pt = (points - points0) / sig_pt[:, None]
    w_pt = _huber_sqrt_weight(torch.linalg.vector_norm(r_pt, dim=-1), 3.0 / n_obs)
    pt_on = p.pt_in_ba
    if not cfg.use_point_priors:
        pt_on = torch.zeros_like(pt_on)
    w_pt = torch.where(pt_on, w_pt, 0.0)
    r_pt = r_pt * w_pt[:, None]
    j_pt = (w_pt / sig_pt)[:, None].expand(-1, 3)                          # [L, 3]

    r_k = (intr[:2] - intr0[:2]) / K_SIGMA
    j_k = torch.full((2,), 1.0 / K_SIGMA, dtype=intr.dtype, device=intr.device)

    # absolute pose anchors: tight, un-robustified se(3) priors on the
    # masked cameras (an absolute reference is trusted by construction)
    if p.abs_pose is not None:
        sig_abs = _sigmas(cfg.abs_sigma_rot, cfg.abs_sigma_pos, poses)
        # unanchored rows may hold garbage (zeros), which would poison the
        # masked product (0 * NaN), so they become the identity
        eye = torch.eye(4, dtype=poses.dtype, device=poses.device)
        safe_abs = torch.where(p.abs_mask[:, None, None], p.abs_pose, eye)
        r_abs = log_se3(poses @ inverse_se3(safe_abs)) / sig_abs
        w_abs = (p.abs_mask & p.cam_in_ba & (~p.cam_fixed)).to(poses.dtype)
        r_abs = r_abs * w_abs[:, None]
        j_abs = w_abs[:, None] / sig_abs
    else:
        r_abs = torch.zeros_like(r_pose)
        j_abs = torch.zeros_like(j_pose)
    return (r_pose, j_pose), (r_pt, j_pt), (r_k, j_k), (r_abs, j_abs)


def _seg_outer(J1, J2, idx, n):
    """sum over observations of J1^T J2 per segment: [O, 2, a], [O, 2, b] -> [n, a, b]."""
    out = J1.new_zeros((n, J1.shape[2], J2.shape[2]))
    return out.index_add_(0, idx, torch.einsum("oki,okj->oij", J1, J2))


def _seg_vec(J, t, idx, n):
    """sum over observations of J^T t per segment: [O, 2, a], [O, 2] -> [n, a]."""
    out = J.new_zeros((n, J.shape[2]))
    return out.index_add_(0, idx, torch.einsum("oki,ok->oi", J, t))


def _huber_rho(n, k):
    return torch.where(n <= k, 0.5 * n * n, k * n - 0.5 * k * k)


def ba_cost(poses, points, intr, p: BAProblem, anchors=None,
            cfg: BAConfig = BAConfig()) -> torch.Tensor:
    """Total robust cost 0.5 * sum(rho(r)), a 0-d tensor."""
    _, pc = _camera_points(poses, points, p)
    z = pc[:, 2]
    good = p.obs_mask & p.cam_in_ba[p.obs_cam] & p.pt_in_ba[p.obs_pt]
    z_safe = torch.where(z > 1e-4, z, 1.0)
    u = intr[0] * pc[:, 0] / z_safe + intr[2]
    v = intr[1] * pc[:, 1] / z_safe + intr[3]
    r = (torch.stack([u, v], -1) - p.obs_uv) / PX_SIGMA
    rn = torch.linalg.vector_norm(r, dim=-1)
    rn = torch.where(z > 1e-4, rn, 2.0 * PX_HUBER + 100.0)    # behind the camera: big
    cost = torch.where(good, _huber_rho(rn, PX_HUBER), 0.0).sum()
    if anchors is not None:
        (r_pose, _), (r_pt, _), (r_k, _), (r_abs, _) = _prior_terms(
            poses, points, intr, p, anchors, cfg)
        cost = cost + _huber_rho(torch.linalg.vector_norm(r_pose, dim=-1), POSE_HUBER).sum()
        cost = cost + 0.5 * (r_pt * r_pt).sum()
        cost = cost + 0.5 * (r_k * r_k).sum()
        cost = cost + 0.5 * (r_abs * r_abs).sum()
    return cost


def _damp(M, lam, on=None):
    """LM damping lam * diag(M) with a small absolute floor, so that empty
    blocks stay invertible; blocks that are off become the identity."""
    d = M.diagonal(dim1=-2, dim2=-1)
    out = M + torch.diag_embed(lam * d + 1e-8)
    if on is not None:
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        out = torch.where(on[:, None, None], out, eye)
    return out


def _blocks(r, Jc, Jp, Jk, priors, p: BAProblem, lam):
    """Blocks of the linearized system shared by both Schur solvers."""
    N = p.poses.shape[0]
    L = p.points.shape[0]
    (r_pose, j_pose), (r_pt, j_pt), (r_k, j_k), (r_abs, j_abs) = priors

    cam_upd = p.cam_in_ba & (~p.cam_fixed)    # cameras that receive updates
    cam_w = cam_upd[:, None].to(r.dtype)      # [N, 1]
    pt_w = p.pt_in_ba[:, None].to(r.dtype)

    U_obs = _seg_outer(Jc, Jc, p.obs_cam, N)                       # [N, 6, 6]
    V_obs = _seg_outer(Jp, Jp, p.obs_pt, L)                        # [L, 3, 3]
    Ukk_obs = torch.einsum("oki,okj->ij", Jk, Jk)                  # [2, 2]

    U = _damp(U_obs + torch.diag_embed(j_pose * j_pose + j_abs * j_abs), lam, cam_upd)
    V = _damp(V_obs + torch.diag_embed(j_pt * j_pt), lam, p.pt_in_ba)
    Ukk = _damp(Ukk_obs + torch.diag(j_k * j_k), lam)

    # the implicit operator applies the observation part through segment
    # sums; the rest of the diagonal (priors, damping, floor) is applied
    # explicitly and must match U / Ukk exactly
    extra_diag_c = U.diagonal(dim1=-2, dim2=-1) - U_obs.diagonal(dim1=-2, dim2=-1)
    extra_diag_k = Ukk.diagonal() - Ukk_obs.diagonal()

    Vinv = inv3x3(V)                                               # [L, 3, 3]

    b_c = (-_seg_vec(Jc, r, p.obs_cam, N) - r_pose * j_pose - r_abs * j_abs) * cam_w
    b_p = (-_seg_vec(Jp, r, p.obs_pt, L) - r_pt * j_pt) * pt_w
    b_k = -torch.einsum("oki,ok->i", Jk, r) - r_k * j_k

    # reduced right-hand side: b~ = b_cams - W V^-1 b_p
    h = torch.einsum("lij,lj->li", Vinv, b_p)                      # [L, 3]
    t = torch.einsum("oki,oi->ok", Jp, h[p.obs_pt])                # [O, 2]
    b_red_c = b_c - _seg_vec(Jc, t, p.obs_cam, N) * cam_w
    b_red_k = b_k - torch.einsum("oki,ok->i", Jk, t)
    return dict(N=N, L=L, cam_upd=cam_upd, cam_w=cam_w, pt_w=pt_w,
                U=U, V=V, Ukk=Ukk, Vinv=Vinv,
                extra_diag_c=extra_diag_c, extra_diag_k=extra_diag_k,
                b_c=b_c, b_p=b_p, b_k=b_k, b_red_c=b_red_c, b_red_k=b_red_k)


def _back_substitute(d_cam, d_k, blk, Jc, Jp, Jk, p: BAProblem):
    """Landmark updates given the camera and intrinsics updates."""
    t = torch.einsum("okj,oj->ok", Jc, d_cam[p.obs_cam]) + Jk @ d_k
    g = blk["b_p"] - _seg_vec(Jp, t, p.obs_pt, blk["L"])
    return torch.einsum("lij,lj->li", blk["Vinv"], g) * blk["pt_w"]


def _solve_schur_dense(r, Jc, Jp, Jk, priors, p: BAProblem, lam, cfg: BAConfig):
    """One linear solve through the materialized reduced camera system.

    Scatters W = [L, N, 6, 3] in one ``index_add_``, forms S = U - W V^-1
    W^T as one [6N, 3L] x [3L, 6N] product, and solves the dense [6N + 2]
    system: a handful of large operations instead of ``cg_iters``
    sequential operator applications.
    Returns (d_cam [N, 6], d_k [2], d_pt [L, 3]).
    """
    blk = _blocks(r, Jc, Jp, Jk, priors, p, lam)
    N, L = blk["N"], blk["L"]
    cam_w, Vinv = blk["cam_w"], blk["Vinv"]
    n6 = 6 * N

    # frozen cameras contribute nothing to the reduced system (their updates
    # are pinned to zero), as in the implicit operator
    Jc_act = Jc * cam_w[p.obs_cam][:, None, :]
    W = Jc.new_zeros((L * N, 6, 3)).index_add_(
        0, p.obs_pt * N + p.obs_cam, torch.einsum("oki,okj->oij", Jc_act, Jp))
    Wk = _seg_outer(Jk, Jp, p.obs_pt, L)                              # [L, 2, 3]
    Uck = _seg_outer(Jc_act, Jk, p.obs_cam, N)                        # [N, 6, 2]

    W_pack = W.view(L, N, 6, 3).permute(3, 0, 1, 2).reshape(3, L, n6)
    Y_pack = torch.einsum("blq,lbc->clq", W_pack, Vinv)               # [3, L, 6N]
    Yk = torch.einsum("lab,lbc->lac", Wk, Vinv)                       # [L, 2, 3]

    S_cc = -(Y_pack.reshape(3 * L, n6).t() @ W_pack.reshape(3 * L, n6))
    S_ck = Uck - torch.einsum("clq,lbc->qb", Y_pack, Wk).reshape(N, 6, 2)
    S_kk = blk["Ukk"] - torch.einsum("lac,lbc->ab", Yk, Wk)

    # the diagonal U blocks already hold damping, priors, and identity rows
    # for frozen cameras
    S_cc = S_cc + _block_diagonal(blk["U"])
    Sck = (S_ck * cam_w[:, :, None]).reshape(n6, 2)
    A = torch.cat([torch.cat([S_cc, Sck], 1), torch.cat([Sck.t(), S_kk], 1)], 0)
    b = torch.cat([blk["b_red_c"].reshape(n6), blk["b_red_k"]])
    if cfg.dense_cg_iters > 0:
        # Jacobi-preconditioned CG on the materialized matrix, a fixed
        # number of steps: exact enough for an LM step on the damped system
        diag = torch.clamp(A.diagonal(), min=1e-12)
        x = torch.zeros_like(b)
        res = b
        z = b / diag
        pvec = z
        rz = res @ z
        for _ in range(cfg.dense_cg_iters):
            Ap = A @ pvec
            alpha = rz / torch.clamp(pvec @ Ap, min=1e-20)
            x = x + alpha * pvec
            res = res - alpha * Ap
            z = res / diag
            rz2 = res @ z
            pvec = z + (rz2 / torch.clamp(rz, min=1e-20)) * pvec
            rz = rz2
        dx = x
    else:
        # S is SPD after damping; a factorization that fails or a solution
        # that is not finite gives the zero step
        Lc, info = torch.linalg.cholesky_ex(A)
        dx = torch.cholesky_solve(b[:, None], Lc)[:, 0]
        dx = torch.where(dx.isfinite().all() & (info == 0), dx, torch.zeros_like(dx))
    d_cam = dx[:n6].reshape(N, 6) * cam_w
    d_k = dx[n6:]
    return d_cam, d_k, _back_substitute(d_cam, d_k, blk, Jc, Jp, Jk, p)


def _block_diagonal(U: torch.Tensor) -> torch.Tensor:
    """[N, a, a] blocks -> the [N a, N a] block-diagonal matrix."""
    N, a, _ = U.shape
    out = U.new_zeros((N, a, N, a))
    ii = torch.arange(N, device=U.device)
    out[ii, :, ii, :] = U
    return out.reshape(N * a, N * a)


def _solve_schur_pcg(r, Jc, Jp, Jk, priors, p: BAProblem, lam, cfg: BAConfig):
    """One linear solve with the reduced system applied matrix-free.

    Eliminates the landmark blocks, runs block-Jacobi PCG on the reduced
    (cameras + K) system, then back-substitutes the landmark updates. The
    loop ends on ``cg_iters`` or on the relative residual ``cg_tol``: it
    reads one flag per step.
    Returns (d_cam [N, 6], d_k [2], d_pt [L, 3]).
    """
    blk = _blocks(r, Jc, Jp, Jk, priors, p, lam)
    N, L = blk["N"], blk["L"]
    cam_upd, cam_w, pt_w = blk["cam_upd"], blk["cam_w"], blk["pt_w"]
    Vinv = blk["Vinv"]
    extra_diag_c, extra_diag_k = blk["extra_diag_c"], blk["extra_diag_k"]
    b_red_c, b_red_k = blk["b_red_c"], blk["b_red_k"]

    # (inv_ex: no error flag is read back to the host)
    Uinv = torch.linalg.inv_ex(blk["U"]).inverse         # [N, 6, 6] (preconditioner)
    Ukk_inv = torch.linalg.inv_ex(blk["Ukk"]).inverse

    def S_mv(vc, vk):
        vc_act = vc * cam_w
        t = torch.einsum("okj,oj->ok", Jc, vc_act[p.obs_cam]) + Jk @ vk     # [O, 2]
        g = _seg_vec(Jp, t, p.obs_pt, L)                                    # [L, 3]
        hh = torch.einsum("lij,lj->li", Vinv, g) * pt_w
        tu = t - torch.einsum("oki,oi->ok", Jp, hh[p.obs_pt])
        Sc = _seg_vec(Jc, tu, p.obs_cam, N) + extra_diag_c * vc_act
        Sc = torch.where(cam_upd[:, None], Sc, vc)      # identity rows for frozen
        Sk = torch.einsum("oki,ok->i", Jk, tu) + extra_diag_k * vk
        return Sc, Sk

    def M_inv(vc, vk):
        return torch.einsum("nij,nj->ni", Uinv, vc), Ukk_inv @ vk

    x_c = torch.zeros_like(b_red_c)
    x_k = torch.zeros_like(b_red_k)
    r_c, r_k2 = b_red_c, b_red_k
    z_c, z_k = M_inv(r_c, r_k2)
    p_c, p_k = z_c, z_k
    rz = (r_c * z_c).sum() + (r_k2 * z_k).sum()
    stop = cfg.cg_tol * (torch.sqrt((b_red_c * b_red_c).sum() + (b_red_k * b_red_k).sum())
                         + 1e-20)
    for _ in range(cfg.cg_iters):
        if not bool(torch.sqrt((r_c * r_c).sum() + (r_k2 * r_k2).sum()) > stop):
            break
        Ap_c, Ap_k = S_mv(p_c, p_k)
        pAp = (p_c * Ap_c).sum() + (p_k * Ap_k).sum()
        alpha = rz / torch.clamp(pAp, min=_EPS)
        x_c = x_c + alpha * p_c
        x_k = x_k + alpha * p_k
        r_c = r_c - alpha * Ap_c
        r_k2 = r_k2 - alpha * Ap_k
        z_c, z_k = M_inv(r_c, r_k2)
        rz_new = (r_c * z_c).sum() + (r_k2 * z_k).sum()
        beta = rz_new / torch.clamp(rz, min=_EPS)
        p_c = z_c + beta * p_c
        p_k = z_k + beta * p_k
        rz = rz_new
    d_cam = x_c * cam_w
    return d_cam, x_k, _back_substitute(d_cam, x_k, blk, Jc, Jp, Jk, p)


def _dogleg_step(r, Jc, Jp, Jk, priors, p: BAProblem, delta, cfg: BAConfig, solve):
    """Powell dogleg: blend the Gauss-Newton step with the Cauchy
    (steepest-descent) step inside the trust radius ``delta``.
    Returns (d_cam, d_k, d_pt, model_decrease)."""
    blk = _blocks(r, Jc, Jp, Jk, priors, p, 1e-8)
    (_, j_pose), (_, j_pt), (_, j_k), (_, j_abs) = priors
    # negative gradient g = b (the blocks hold b = -J^T r, masked)
    g = (blk["b_c"], blk["b_k"], blk["b_p"])

    def dot_all(a, b):
        return sum((x * y).sum() for x, y in zip(a, b))

    def Jh_sq(h):
        """||J h||^2 over the observations and the prior rows."""
        hc, hk, hp = h
        t = (torch.einsum("okj,oj->ok", Jc, hc[p.obs_cam]) + Jk @ hk
             + torch.einsum("okj,oj->ok", Jp, hp[p.obs_pt]))
        return ((t * t).sum() + ((j_pose * hc) ** 2).sum() + ((j_abs * hc) ** 2).sum()
                + ((j_pt * hp) ** 2).sum() + ((j_k * hk) ** 2).sum())

    g_norm2 = dot_all(g, g)
    alpha = g_norm2 / torch.clamp(Jh_sq(g), min=_EPS)
    sd = tuple(alpha * x for x in g)
    sd_norm = torch.sqrt(alpha * alpha * g_norm2)

    gn = solve(r, Jc, Jp, Jk, priors, p, 1e-8, cfg)
    gn_norm = torch.sqrt(dot_all(gn, gn))

    # blend factor of the segment sd -> gn where it meets the trust boundary
    d = tuple(a - b for a, b in zip(gn, sd))
    a = dot_all(d, d)
    b_lin = 2.0 * dot_all(sd, d)
    c_quad = sd_norm * sd_norm - delta * delta
    disc = torch.clamp(b_lin * b_lin - 4.0 * a * c_quad, min=0.0)
    beta = torch.clamp((-b_lin + torch.sqrt(disc)) / torch.clamp(2.0 * a, min=_EPS), 0.0, 1.0)

    use_gn = gn_norm <= delta
    sd_clip = torch.clamp(delta / torch.clamp(sd_norm, min=_EPS), max=1.0)
    use_sd = (~use_gn) & (sd_norm >= delta)
    h = tuple(torch.where(use_gn, x_gn, torch.where(use_sd, sd_clip * x_sd, x_sd + beta * x_d))
              for x_gn, x_sd, x_d in zip(gn, sd, d))

    # model decrease m(0) - m(h) = g^T h - 0.5 ||J h||^2
    m_dec = dot_all(g, h) - 0.5 * Jh_sq(h)
    return h[0], h[1], h[2], m_dec


def use_dense_solver(p: BAProblem, cfg: BAConfig) -> bool:
    """The solver ``cfg.solver`` stands for on problem ``p`` (see BAConfig)."""
    if cfg.solver == "dense":
        return True
    if cfg.solver == "pcg":
        return False
    return p.points.shape[0] * p.poses.shape[0] * 8 * 128 * 4 <= cfg.dense_budget_bytes


@torch.no_grad()
def refine_ba(p: BAProblem, cfg: BAConfig = BAConfig()):
    """Run LM (or dogleg) until the relative cost decrease of an accepted
    step falls under ``cfg.tolerance``, the damping stalls, or ``max_iters``.

    Returns (poses, points, intr, info) with ``info`` holding
    ``initial_cost``, ``final_cost``, ``lambda`` (0-d tensors) and
    ``iterations`` (int).
    """
    if p.abs_pose is not None:
        # absolute references replace the init-anchored weak priors: those
        # regularize toward the drifted initialization, which is exactly
        # the state the anchors exist to correct
        cfg = cfg._replace(use_pose_priors=False, use_point_priors=False)
    anchors = (p.poses, p.points, p.intr)
    solve = _solve_schur_dense if use_dense_solver(p, cfg) else _solve_schur_pcg
    dogleg = cfg.method.lower() == "dogleg"

    poses, points, intr = p.poses, p.points, p.intr
    cost0 = ba_cost(poses, points, intr, p, anchors, cfg)
    cost = cost0
    # with dogleg the "lam" slot carries the trust radius
    lam = poses.new_full((), cfg.trust_radius_init if dogleg else cfg.lambda_init)
    n_it = 0
    while n_it < cfg.max_iters:
        priors = _prior_terms(poses, points, intr, p, anchors, cfg)
        r, Jc, Jp, Jk = _obs_linearize(poses, points, intr, p)
        if dogleg:
            d_cam, d_k, d_pt, m_dec = _dogleg_step(r, Jc, Jp, Jk, priors, p, lam, cfg, solve)
        else:
            d_cam, d_k, d_pt = solve(r, Jc, Jp, Jk, priors, p, lam, cfg)

        new_poses = exp_se3(d_cam) @ poses
        new_points = points + d_pt
        new_intr = torch.cat([intr[:2] + d_k, intr[2:]])
        new_cost = ba_cost(new_poses, new_points, new_intr, p, anchors, cfg)
        accept = new_cost < cost

        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        intr = torch.where(accept, new_intr, intr)
        if dogleg:
            rho = (cost - new_cost) / torch.clamp(m_dec, min=_EPS)
            lam = torch.where(rho > 0.75, lam * 2.0, torch.where(rho < 0.25, lam * 0.5, lam))
            lam = torch.clamp(lam, 1e-6, 1e6)
            stalled = lam <= 1e-6
        else:
            lam = torch.where(accept, torch.clamp(lam / 3.0, min=cfg.lambda_min),
                              torch.clamp(lam * 4.0, max=cfg.lambda_max))
            stalled = lam >= cfg.lambda_max
        rel = (cost - new_cost).abs() / torch.clamp(cost, min=_EPS)
        done = (accept & (rel < cfg.tolerance)) | stalled
        cost = torch.where(accept, new_cost, cost)
        n_it += 1
        if bool(done):      # the iteration's one read-back
            break
    info = {"initial_cost": cost0, "final_cost": cost, "iterations": n_it, "lambda": lam}
    return poses, points, intr, info
