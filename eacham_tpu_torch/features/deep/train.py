"""Self-supervised training of the deep frontend on synthetic scenes (port
of eacham_tpu/features/deep/train.py).

The deep models are trained from scratch the MagicPoint/SuperPoint way, on
rendered geometry with exact ground truth (``utils.synthetic`` renders blob
fields and textured surfaces with known projections):

  * detector: bilinear cross-entropy of the heatmap at the subpixel GT
    keypoints
  * descriptor field: two-way InfoNCE across two views of one scene
  * matcher: log dual-softmax NLL at the GT partner + matchability BCE

The data functions are numpy, as in the reference, so the same
``np.random.default_rng(seed)`` gives the same arrays in both packages;
``make_sp_batch`` extracts on the card and labels on the host. Optax's
Adam, global-norm clip and warm-up cosine schedule are written out here
with optax's own rules (``clip_by_global_norm_``,
``warmup_cosine_decay_schedule``). The trainers run on the card unless the
caller passes ``device="cpu"``, take modules (``params=None`` initialises
one from ``generator``), train a copy, and return ``(model, losses)``; none
writes a file (``lightglue.save_params`` to a path of the caller's).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from eacham_tpu_torch.device import resolve_device
from eacham_tpu_torch.features.deep import lightglue as lg
from eacham_tpu_torch.features.deep import superpoint as sp
from eacham_tpu_torch.features.deep.frontend import extract_deep_batch
from eacham_tpu_torch.utils.synthetic import (
    make_blob_scene, make_surface_scene, make_texture, orbit_poses,
    photometric_augment, render_view,
)
from eacham_tpu_torch.utils.timer import BlockTimer


# --------------------------------------------------------------------------
# data generation (numpy: the reference's arrays from the same generator)
# --------------------------------------------------------------------------

def sample_pair(rng, width=160, height=120, n_blobs=60, max_kps=64, world="blob"):
    """Two views of one scene + GT kp locations and correspondence.

    ``world``: "blob" (volumetric field, near-identity poses), "surface"
    (textured-surface sphere from the production orbit shell) or "mix"
    (50/50 per pair)."""
    f = 1.2 * max(width, height)
    intr = np.array([f, f, width / 2, height / 2], np.float32)
    if world == "mix":
        world = "surface" if rng.random() < 0.5 else "blob"
    if world == "surface":
        scene = make_surface_scene(rng, n_blobs=max(n_blobs, 1500))
        center = np.array([0.0, 0.0, 9.0], np.float32)
        a0 = rng.uniform(0, 2 * np.pi)
        da = np.deg2rad(rng.uniform(0.75, 8.0)) * rng.choice([-1.0, 1.0])
        T0 = _orbit_pose(a0, center, 14.0)
        T1 = _orbit_pose(a0 + da, center, 14.0)
    else:
        scene = make_blob_scene(rng, n_blobs=n_blobs, depth=(3.0, 7.0), spread=1.3)

        def rand_pose():
            T = np.eye(4, dtype=np.float32)
            a = rng.uniform(-0.06, 0.06)
            c, s = np.cos(a), np.sin(a)
            T[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
            T[:3, 3] = rng.uniform(-0.25, 0.25, 3).astype(np.float32)
            return T

        T0, T1 = rand_pose(), rand_pose()
    img0 = render_view(scene, T0, intr, width, height)
    img1 = render_view(scene, T1, intr, width, height)

    def project(T):
        pc = scene["pts"] @ T[:3, :3].T + T[:3, 3]
        u = f * pc[:, 0] / pc[:, 2] + intr[2]
        v = f * pc[:, 1] / pc[:, 2] + intr[3]
        vis = (pc[:, 2] > 0.5) & (u >= 4) & (u < width - 4) & (v >= 4) & (v < height - 4)
        if world == "surface":
            # only the camera-facing hemisphere is rendered: a far-side
            # point is no keypoint
            cam = -T[:3, :3].T @ T[:3, 3]
            center = np.array([0.0, 0.0, 9.0], np.float32)
            n_hat = scene["pts"] - center
            vis = vis & (np.sum(n_hat * (cam - scene["pts"]), axis=1) > 0)
        return np.stack([u, v], -1), vis

    uv0, vis0 = project(T0)
    uv1, vis1 = project(T1)
    idx = np.nonzero(vis0 & vis1)[0]
    if len(idx) > max_kps:
        idx = rng.choice(idx, size=max_kps, replace=False)
    k = len(idx)
    kp0 = np.zeros((max_kps, 2), np.float32)
    kp1 = np.zeros((max_kps, 2), np.float32)
    kp0[:k] = uv0[idx]
    kp1[:k] = uv1[idx]
    mask = np.arange(max_kps) < k
    return img0, img1, kp0, kp1, mask, (width, height)


def make_batch(rng, batch=8, **kw):
    outs = [sample_pair(rng, **kw) for _ in range(batch)]
    img0 = np.stack([o[0] for o in outs])
    img1 = np.stack([o[1] for o in outs])
    kp0 = np.stack([o[2] for o in outs])
    kp1 = np.stack([o[3] for o in outs])
    mask = np.stack([o[4] for o in outs])
    return img0, img1, kp0, kp1, mask, outs[0][5]


def synthetic_matches(rng, batch, n_kps, noise, outlier_frac):
    """``train_lightglue``'s batch: GT-corresponding keypoints (a slight
    affine warp + jitter, shuffled) share a noisy random descriptor;
    outliers get fresh ones. Returns (kp0, d0, kp1, d1, gt) with gt[b, i]
    the position of i's partner in view 2, or -1 (the reference's inner
    ``gen``)."""
    B, N = batch, n_kps
    kp0 = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    A = np.eye(2) + rng.normal(scale=0.05, size=(B, 1, 2, 2))
    t = rng.normal(scale=0.2, size=(B, 1, 2))
    kp1 = np.einsum("bnij,bnj->bni", np.broadcast_to(A, (B, N, 2, 2)), kp0) + t
    kp1 += rng.normal(scale=0.01, size=kp1.shape)
    d = rng.normal(size=(B, N, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # noise scaled to the per-component signal of a unit descriptor
    nscale = noise / np.sqrt(d.shape[-1])
    d0 = d + nscale * rng.normal(size=d.shape).astype(np.float32)
    d1 = d + nscale * rng.normal(size=d.shape).astype(np.float32)
    outlier = rng.random((B, N)) < outlier_frac
    d_out = rng.normal(size=(B, N, 256)).astype(np.float32)
    d1 = np.where(outlier[..., None], d_out, d1)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(N) for _ in range(B)])
    kp1 = np.take_along_axis(kp1, perm[..., None], 1)
    d1 = np.take_along_axis(d1, perm[..., None], 1)
    gt = np.where(outlier, -1, np.argsort(perm, axis=1))
    return (kp0.astype(np.float32), d0, kp1.astype(np.float32), d1, gt.astype(np.int32))


def _orbit_pose(a, center, orbit_r):
    """One inward-looking camera on the stress-orbit shell."""
    cam = center + orbit_r * np.array(
        [np.sin(a), 0.025 * np.sin(5 * a), -np.cos(a)], np.float32)
    fwd = center - cam
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd]).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = -R @ cam
    return T


def sample_image_pair(rng, width=160, height=120, n_blobs=70, textured=True, world="blob"):
    """Two augmented renders of one scene + the scene/pose GT needed to
    label detected-keypoint correspondences: (img0, img1, scene, T0, T1,
    intr).

    ``world``: "blob" = the volumetric textured-blob field (near-identity
    pose pairs); "surface" = the textured-surface sphere, half the pairs
    from the inward look-at orbit at window-scale angular offsets, half
    from ``orbit_poses`` near the sphere (rotation-dominant flow).
    """
    f = 1.2 * max(width, height)
    intr = np.array([f, f, width / 2, height / 2], np.float32)

    if world == "surface":
        # n_blobs <= 500 means the blob-world default: the production
        # appearance density (4000 blobs at 512x384) scaled to this render
        scene = make_surface_scene(
            rng, n_blobs=(n_blobs if n_blobs > 500
                          else max(300, int(0.0203 * width * height))))
        if rng.random() < 0.5:
            center = np.array([0.0, 0.0, 9.0], np.float32)
            a0 = rng.uniform(0, 2 * np.pi)
            da = np.deg2rad(rng.uniform(0.75, 8.0)) * rng.choice([-1.0, 1.0])
            T0 = _orbit_pose(a0, center, 14.0)
            T1 = _orbit_pose(a0 + da, center, 14.0)
        else:
            i = int(rng.integers(0, 90))
            j = i + int(rng.integers(1, 11))
            traj = orbit_poses(j + 1, radius=0.6, step_deg=0.8, advance=0.04)
            T0, T1 = traj[i], traj[j]
    else:
        scene = make_blob_scene(rng, n_blobs=n_blobs, depth=(3.0, 7.0), spread=1.3)

        def rand_pose():
            T = np.eye(4, dtype=np.float32)
            a = rng.uniform(-0.08, 0.08)
            c, s = np.cos(a), np.sin(a)
            T[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
            T[:3, 3] = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
            return T

        T0, T1 = rand_pose(), rand_pose()
    bg0 = make_texture(rng, height, width) if textured else None
    bg1 = make_texture(rng, height, width) if textured else None
    img0 = render_view(scene, T0, intr, width, height, background=bg0)
    img1 = render_view(scene, T1, intr, width, height, background=bg1)
    img0 = photometric_augment(img0, rng)
    img1 = photometric_augment(img1, rng)
    return img0, img1, scene, T0, T1, intr


def _label_correspondence(xy0, m0, xy1, m1, scene, T0, T1, intr, tol=3.0, assoc_r=10.0):
    """gt[i] = index of xy0[i]'s true partner among the detected xy1 (or
    -1), by flow transfer through each keypoint's governing blob.

    The renderer's blobs are pixel-anchored sprites, so a texture feature at
    offset (dx, dy) from its blob's center reappears at the same offset in
    the other view: the partner of a detected keypoint is kp + (proj1(g) -
    proj0(g)) for its governing blob g (the nearest visible projection)."""
    def project(T):
        pc = scene["pts"] @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = intr[0] * pc[:, 0] / z + intr[2]
        v = intr[1] * pc[:, 1] / z + intr[3]
        good = pc[:, 2] > 0.5
        if "center" in scene:
            # surface world: only the camera-facing hemisphere is rendered
            cam = -T[:3, :3].T @ T[:3, 3]
            n_hat = scene["pts"] - scene["center"]
            good = good & (np.sum(n_hat * (cam - scene["pts"]), axis=1) > 0)
        return np.stack([u, v], -1), good

    proj0, vis0 = project(T0)
    proj1, vis1 = project(T1)
    xy0 = np.asarray(xy0)
    xy1 = np.asarray(xy1)
    m0 = np.asarray(m0)
    m1 = np.asarray(m1)

    d0 = np.linalg.norm(xy0[:, None, :] - proj0[None, :, :], axis=-1)
    d0 = np.where(vis0[None, :], d0, np.inf)
    g = np.argmin(d0, axis=1)
    ok = (d0[np.arange(len(xy0)), g] < assoc_r) & m0 & vis1[g]

    pred = xy0 + proj1[g] - proj0[g]
    d1 = np.linalg.norm(pred[:, None, :] - xy1[None, :, :], axis=-1)
    d1 = np.where(m1[None, :], d1, np.inf)
    j = np.argmin(d1, axis=1)
    ok = ok & (d1[np.arange(len(xy0)), j] < tol)
    return np.where(ok, j, -1).astype(np.int32)


def render_pair_batch(rng, batch=8, width=160, height=120, n_blobs=70, textured=True,
                      world="blob"):
    """``batch`` rendered training pairs (the host half of
    ``make_sp_batch``; numpy only, so it runs in worker processes). The
    blob density scales with the render area (70 at 160x120)."""
    n_eff = max(30, int(round(n_blobs * (width * height) / (160 * 120))))

    def pick_world():
        if world == "mix":
            return "surface" if rng.random() < 0.5 else "blob"
        return world

    return [sample_image_pair(rng, width, height, n_eff, textured, world=pick_world())
            for _ in range(batch)]


def _pool_worker_init():
    """Initializer of the render workers: hide every card from the worker
    before anything in it touches CUDA, so that a worker can never take the
    card the training step owns (the reference sets JAX_PLATFORMS=cpu)."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _render_pairs_task(args):
    seed, batch, width, height, n_blobs, textured, world = args
    rng = np.random.default_rng(seed)
    return render_pair_batch(rng, batch, width, height, n_blobs, textured, world)


def make_sp_batch(sp_params: sp.SuperPointNet, rng, batch=8, width=160, height=120,
                  n_blobs=70, max_kps=64, textured=True, world="blob", pairs=None):
    """A LightGlue training batch whose keypoints and descriptors come from
    the SuperPoint forward pass (no grad, on ``sp_params``' device), labelled
    on the host: numpy (kp0, d0, m0, kp1, d1, m1, gt), keypoints normalized
    to ~[-1, 1]. ``pairs``: pre-rendered output of ``render_pair_batch``
    (from a worker pool); otherwise they are rendered here from ``rng``."""
    if pairs is None:
        pairs = render_pair_batch(rng, batch, width, height, n_blobs, textured, world)
    batch = len(pairs)
    imgs = np.stack([p[0] for p in pairs] + [p[1] for p in pairs])
    dev = next(sp_params.parameters()).device
    xy, desc, score, mask = (t.cpu().numpy() for t in extract_deep_batch(
        sp_params, imgs, max_keypoints=max_kps, device=dev))
    # per-world keypoint budget: a blob-world frame holds only ~70-140 true
    # features, so blob pairs keep their top half by detector score and
    # surface worlds keep everything
    kp_budget = max_kps // 2
    for b, (_, _, sc, _, _, _) in enumerate(pairs):
        if "center" not in sc and kp_budget < max_kps:
            for side in (b, batch + b):
                order = np.argsort(-score[side])
                keep = np.zeros(max_kps, bool)
                keep[order[:kp_budget]] = True
                mask[side] &= keep
    gts = [_label_correspondence(xy[b], mask[b], xy[batch + b], mask[batch + b],
                                 scene, T0, T1, intr)
           for b, (_, _, scene, T0, T1, intr) in enumerate(pairs)]
    kps = lg.normalize_keypoints(torch.from_numpy(xy), float(width), float(height)).numpy()
    return (kps[:batch], desc[:batch], mask[:batch],
            kps[batch:], desc[batch:], mask[batch:], np.stack(gts))


# --------------------------------------------------------------------------
# optimiser pieces (optax's rules)
# --------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0):
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to ``end_value``
    at ``decay_steps`` (which counts the warm-up). Raises ValueError unless
    ``decay_steps > warmup_steps``, as optax does."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={cos_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count):
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def lightglue_schedule(steps, lr):
    """``train_lightglue``'s learning rate by update count: a warm-up of
    max(50, steps // 20) updates from 0, cosine decay to 0 at ``steps``
    (ValueError for steps <= 50)."""
    return warmup_cosine_decay_schedule(0.0, lr, warmup_steps=max(50, steps // 20),
                                        decay_steps=max(steps, 1))


def lightglue_sp_schedule(steps, lr):
    """``train_lightglue_sp``'s learning rate by update count: a warm-up of
    min(max(20, steps // 20), max(steps // 2, 1)) updates from 0, cosine
    decay to lr / 5 at ``steps``."""
    warmup = min(max(20, steps // 20), max(steps // 2, 1))
    return warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                        decay_steps=max(steps, warmup + 1), end_value=lr * 0.2)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient is left as it is
    when the global norm is below ``max_norm``, else scaled by max_norm /
    norm (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns
    the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    # g / norm * max_norm where clipped, g / 1 * 1 (exact) where not: two
    # fused passes over all gradients, with optax's rounding
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, norm.new_tensor(max_norm)))
    return norm


def _adam(model, lr):
    """optax.adam's update (b1 0.9, b2 0.999, eps 1e-8): torch's Adam is the
    same rule."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _trainable_copy(model: torch.nn.Module, dev) -> torch.nn.Module:
    """The caller's module stays as it is: training runs on a copy with
    gradients on (``load_frontend_params`` hands out frozen modules)."""
    return copy.deepcopy(model).to(dev).train().requires_grad_(True)


def _as(batch, dev):
    """numpy batch -> tensors on ``dev``; floats in fp32, as the reference's
    ``jnp.asarray`` gives them (numpy promotes some of them to float64)."""
    out = []
    for a in batch:
        t = torch.as_tensor(np.asarray(a))
        out.append((t.float() if t.is_floating_point() else t).to(dev))
    return out


# --------------------------------------------------------------------------
# losses (plain functions of (model, batch), as the reference's step bodies)
# --------------------------------------------------------------------------

def _sp_loss(model: sp.SuperPointNet, img0, img1, kp0, kp1, mask, anchor_params=None,
             anchor_weight=20.0):
    """SuperPoint loss on tensors: detector cross-entropy against the
    subpixel GT location (the target over the 2x2 neighbourhood carries the
    keypoint's bilinear weights) + two-way InfoNCE of the sampled
    descriptors at temperature 0.07 + optionally ``anchor_weight`` x the L2
    distance of the descriptor fields to ``anchor_params``' (a frozen
    module). Returns (loss, {"det", "desc", "anchor"})."""
    B, H, W = img0.shape

    def side(img, kps):
        heat, desc_field = model(img)
        eps = 1e-8
        x = torch.clamp(kps[..., 0], 0.0, W - 1.001)
        y = torch.clamp(kps[..., 1], 0.0, H - 1.001)
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        fx, fy = x - x0, y - y0
        b = torch.arange(B, device=heat.device)[:, None]
        lh = torch.log(torch.stack([heat[b, y0, x0], heat[b, y0, x0 + 1],
                                    heat[b, y0 + 1, x0], heat[b, y0 + 1, x0 + 1]]) + eps)
        w = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx])
        at_kp = -(w * lh).sum(0)                             # CE per keypoint [B, K]
        det = (at_kp * mask).sum() / torch.clamp(mask.sum(), min=1)

        pts = kps / sp.CELL
        d = sp._bilinear_field(desc_field, pts[..., 0], pts[..., 1])
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
        return det, d, desc_field

    det0, d0, f0 = side(img0, kp0)
    det1, d1, f1 = side(img1, kp1)

    sim = torch.einsum("bkd,bld->bkl", d0, d1) / 0.07
    live = mask[:, :, None] & mask[:, None, :]
    sim = torch.where(live, sim, -1e9)
    diag = torch.diagonal(sim, dim1=1, dim2=2)
    ce_row = torch.logsumexp(sim, dim=2) - diag
    ce_col = torch.logsumexp(sim, dim=1) - diag
    m = mask.float()
    desc_l = ((ce_row + ce_col) * m).sum() / torch.clamp(m.sum(), min=1.0)
    det = det0 + det1
    anchor_l = 0.0
    if anchor_params is not None:
        with torch.no_grad():
            _, a0 = anchor_params(img0)
            _, a1 = anchor_params(img1)
        anchor_l = anchor_weight * 0.5 * (((f0 - a0) ** 2).mean() + ((f1 - a1) ** 2).mean())
    return det + desc_l + anchor_l, {"det": det, "desc": desc_l, "anchor": anchor_l}


def _pick(lp, tgt):
    return torch.gather(lp, 2, tgt[..., None])[..., 0]


def lightglue_loss(model: lg.LightGlueMatcher, kp0, d0, kp1, d1, gt):
    """``train_lightglue``'s loss on tensors (all keypoints live): the log
    dual-softmax NLL at the GT partner over matched rows + 0.5 x the
    matchability BCE over all rows. Returns (loss, (nll, bce))."""
    mask = torch.ones(kp0.shape[:2], dtype=torch.bool, device=kp0.device)
    sim, m0, _ = model.similarity(kp0, d0, mask, kp1, d1, mask)
    logp0 = torch.log_softmax(sim, dim=2)
    logp1 = torch.log_softmax(sim, dim=1)
    matched = gt >= 0
    tgt = torch.clamp(gt, min=0).long()
    nll = -(_pick(logp0, tgt) + _pick(logp1, tgt))
    pos = (nll * matched).sum() / torch.clamp(matched.sum(), min=1)
    eps = 1e-7
    bce = -(torch.where(matched, torch.log(m0 + eps), torch.log(1 - m0 + eps))).mean()
    return pos + 0.5 * bce, (pos, bce)


def lightglue_sp_loss(model: lg.LightGlueMatcher, kp0, d0, m0, kp1, d1, m1, gt):
    """``train_lightglue_sp``'s loss on tensors: as ``lightglue_loss`` with
    masked keypoints, whose similarities are set to -1e9 before each
    log-softmax, and a BCE over the live rows of view 0 only. Returns
    (loss, (nll, bce))."""
    sim, mt0, _ = model.similarity(kp0, d0, m0, kp1, d1, m1)
    logp0 = torch.log_softmax(torch.where(m1[:, None, :], sim, -1e9), dim=2)
    logp1 = torch.log_softmax(torch.where(m0[:, :, None], sim, -1e9), dim=1)
    matched = gt >= 0
    tgt = torch.clamp(gt, min=0).long()
    nll = -(_pick(logp0, tgt) + _pick(logp1, tgt))
    pos = (nll * matched).sum() / torch.clamp(matched.sum(), min=1)
    eps = 1e-7
    bce = -torch.where(matched, torch.log(mt0 + eps),
                       torch.where(m0, torch.log(1 - mt0 + eps), 0.0)
                       ).sum() / torch.clamp(m0.sum(), min=1)
    return pos + 0.5 * bce, (pos, bce)


def _update(model, opt, loss, lr=None, trainable=None, max_norm=None):
    """One optimiser step on ``loss``: gradients (those of modules outside
    ``trainable`` zeroed), the optional global-norm clip, Adam at ``lr``."""
    opt.zero_grad(set_to_none=False)
    loss.backward()
    # a parameter the loss does not reach (match1) keeps no gradient: Adam
    # leaves it as it is, as optax does with its zero gradient
    if trainable is not None:
        for name, p in model.named_parameters():
            if name.split(".")[0] not in trainable and p.grad is not None:
                p.grad.zero_()
    if max_norm is not None:
        clip_by_global_norm_([p.grad for p in model.parameters() if p.grad is not None],
                             max_norm)
    if lr is not None:
        for group in opt.param_groups:
            group["lr"] = lr
    opt.step()


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------

def train_superpoint(steps=200, batch=8, lr=1e-3, seed=0, params=None, log_every=50,
                     trainable=None, anchor_params=None, anchor_weight=20.0,
                     device: str | torch.device | None = "cuda",
                     generator: torch.Generator | None = None, **data_kw):
    """Train a SuperPointNet on ``make_batch`` pairs; returns ``(model,
    losses)``. Fast smoke: steps ~200; real: 10k+.

    ``trainable``: optional set of top-level module names (e.g. {"det1",
    "det2"}): the gradients of every other module are zeroed, so those
    parameters come out bit-identical (a head-only refresh keeps the
    descriptor field a finetuned matcher was trained on).
    ``anchor_params``: a frozen SuperPointNet; when given, an L2 term of
    weight ``anchor_weight`` pins the descriptor field to its output.
    ``params=None`` initialises from ``generator`` (seed ``seed`` by
    default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = sp.init_params(generator or torch.Generator().manual_seed(seed))
    model = _trainable_copy(params, dev)
    anchor = None
    if anchor_params is not None:
        anchor = copy.deepcopy(anchor_params).to(dev).eval().requires_grad_(False)
    opt = _adam(model, lr)

    losses = []
    for i in range(steps):
        img0, img1, kp0, kp1, mask, _ = make_batch(rng, batch=batch, **data_kw)
        l, aux = _sp_loss(model, *_as((img0, img1, kp0, kp1, mask), dev),
                          anchor_params=anchor, anchor_weight=anchor_weight)
        _update(model, opt, l, trainable=trainable)
        losses.append(l.item())
        if log_every and i % log_every == 0:
            print(f"[superpoint] step {i}: loss {losses[-1]:.4f} "
                  f"(det {aux['det'].item():.4f} desc {aux['desc'].item():.4f})", flush=True)
    return model.eval(), losses


def train_lightglue(steps=300, batch=8, lr=3e-4, n_layers=3, seed=0, params=None,
                    log_every=50, noise=0.5, outlier_frac=0.3, n_kps=64, log=print,
                    device: str | torch.device | None = "cuda",
                    generator: torch.Generator | None = None):
    """Train the matcher on ``synthetic_matches`` correspondence sets; a
    clean first third, then noise and outliers ramp to their targets.
    Global-norm clip 1 and Adam on a warm-up cosine schedule (peak ``lr``;
    the first update runs at lr 0, as optax evaluates the schedule before
    counting). Returns ``(model, losses)``. ``steps <= 50`` raises
    ValueError, as in the reference (the warm-up is 50 steps at least).
    Times each update's batch and step under ``BlockTimer``
    ("train_lg/batch", "train_lg/step")."""
    dev = resolve_device(device)
    sched = lightglue_schedule(steps, lr)
    rng = np.random.default_rng(seed)
    if params is None:
        params = lg.init_params(generator or torch.Generator().manual_seed(seed),
                                n_layers=n_layers, n_kps=n_kps)
    model = _trainable_copy(params, dev)
    opt = _adam(model, 0.0)

    losses = []
    warm = max(1, steps // 3)
    for i in range(steps):
        ramp = min(1.0, max(0.0, (i - warm) / max(1, steps - 2 * warm)))
        with BlockTimer("train_lg/batch"):
            b = synthetic_matches(rng, batch, n_kps, 0.1 + ramp * (noise - 0.1),
                                  ramp * outlier_frac)
        with BlockTimer("train_lg/step"):
            l, aux = lightglue_loss(model, *_as(b, dev))
            _update(model, opt, l, lr=sched(i), max_norm=1.0)
            losses.append(l.item())
        if log_every and i % log_every == 0:
            log(f"[lightglue] step {i}: loss {losses[-1]:.4f} "
                f"(nll {aux[0].item():.3f} bce {aux[1].item():.3f})")
    return model.eval(), losses


def train_lightglue_sp(sp_params, steps=300, batch=8, lr=2e-4, n_layers=3, seed=0,
                       params=None, n_kps=64, log_every=25, width=160, height=120,
                       log=print, world="blob", workers=0,
                       device: str | torch.device | None = "cuda",
                       generator: torch.Generator | None = None):
    """Train (or fine-tune) the matcher on SuperPoint-extracted features of
    rendered pairs (``make_sp_batch``). ``sp_params``: the SuperPointNet
    that extracts (moved to ``device``, not trained). ``params``: the
    matcher to fine-tune, None to train one from ``init_params``.
    ``workers > 0``: a spawned pool of that many processes renders ahead,
    at most 2 x workers batches, each from its own task seed. Times each
    step's wait for its render, its extraction + labelling and its update
    under ``BlockTimer`` ("train_sp/render_wait", "train_sp/batch",
    "train_sp/step"). Returns ``(model, losses)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = lg.init_params(generator or torch.Generator().manual_seed(seed),
                                n_layers=n_layers, n_kps=n_kps)
    model = _trainable_copy(params, dev)
    extractor = copy.deepcopy(sp_params).to(dev).eval().requires_grad_(False)
    sched = lightglue_sp_schedule(steps, lr)
    opt = _adam(model, 0.0)

    # rendering is host work (surface worlds paint ~1500 blobs a view) while
    # the step runs on the card: a small process pool renders ahead in a
    # bounded window, so memory stays flat
    pool = None
    pending = []
    if workers > 0:
        from multiprocessing import get_context

        pool = get_context("spawn").Pool(workers, initializer=_pool_worker_init)
        task_seeds = rng.integers(2 ** 31, size=steps)

        def submit(i):
            pending.append(pool.apply_async(_render_pairs_task, (
                (int(task_seeds[i]), batch, width, height, 70, True, world),)))

        for i in range(min(2 * workers, steps)):
            submit(i)

    losses = []
    try:
        for i in range(steps):
            pairs = None
            if pool is not None:
                with BlockTimer("train_sp/render_wait"):
                    pairs = pending.pop(0).get()
                if i + 2 * workers < steps:
                    submit(i + 2 * workers)
            with BlockTimer("train_sp/batch"):
                b = make_sp_batch(extractor, rng, batch=batch, width=width, height=height,
                                  max_kps=n_kps, world=world, pairs=pairs)
            with BlockTimer("train_sp/step"):
                l, aux = lightglue_sp_loss(model, *_as(b, dev))
                _update(model, opt, l, lr=sched(i), max_norm=1.0)
                losses.append(l.item())
            if log_every and i % log_every == 0:
                log(f"[lightglue-sp] step {i}: loss {losses[-1]:.4f} "
                    f"(nll {aux[0].item():.3f} bce {aux[1].item():.3f})")
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    return model.eval(), losses
