"""Parity of the port's geometry (eacham_tpu_torch.geometry) with the JAX
reference on the CPU, inputs drawn from numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.geometry import (
    camera as jcam, epipolar as jepi, homography as jhom, linalg as jlin,
    ransac as jran, se3 as jse3, triangulation as jtri,
)
from eacham_tpu_torch.geometry import (
    camera as tcam, epipolar as tepi, homography as thom, linalg as tlin,
    ransac as tran, se3 as tse3, triangulation as ttri,
)

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _poses(rng, n):
    xi = np.concatenate([rng.normal(scale=0.3, size=(n, 3)),
                         rng.normal(size=(n, 3))], -1).astype(np.float32)
    return np.asarray(jse3.exp_se3(jnp.asarray(xi))), xi


def _two_view(rng, n=200, noise=0.05, outliers=0.2, planar=False):
    """Random 3-D points seen by two cameras: pixels, intrinsics, the GT
    relative pose and an outlier-corrupted match set.

    The pixel noise sits well inside the RANSAC thresholds: an 8-point
    hypothesis is an ill-conditioned fp32 null vector, so the two
    libraries' hypotheses differ at the 1e-4 level, and noise near the
    threshold would turn that into different borderline inliers."""
    f, w, h = 500.0, 640.0, 480.0
    intr = np.array([f, f, w / 2, h / 2], np.float32)
    pts = rng.uniform(-1.5, 1.5, (n, 3))
    pts[:, 2] = 2.0 if planar else rng.uniform(4.0, 8.0, n)
    if planar:
        pts[:, 2] += 5.0
    R = np.asarray(jse3.exp_se3(jnp.asarray([0.02, -0.1, 0.03, 0, 0, 0],
                                            jnp.float32)))[:3, :3]
    t = np.array([0.6, 0.05, 0.1])
    pc2 = pts @ R.T + t
    uv1 = f * pts[:, :2] / pts[:, 2:] + intr[2:]
    uv2 = f * pc2[:, :2] / pc2[:, 2:] + intr[2:]
    uv1 = uv1 + rng.normal(scale=noise, size=uv1.shape)
    uv2 = uv2 + rng.normal(scale=noise, size=uv2.shape)
    bad = rng.random(n) < outliers
    uv2[bad] = rng.uniform([0, 0], [w, h], (bad.sum(), 2))
    mask = rng.random(n) > 0.05
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t / np.linalg.norm(t)
    return (uv1.astype(np.float32), uv2.astype(np.float32), mask, intr, T)


@pytest.mark.parametrize("fn", ["exp_se3", "log_se3", "inverse_se3", "hat"])
def test_se3_parity(rng, fn):
    _, xi = _poses(rng, 16)
    if fn == "log_se3":
        arg = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    elif fn == "hat":
        arg = xi[:, :3]
    elif fn == "inverse_se3":
        arg = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    else:
        arg = xi
    ref = getattr(jse3, fn)(jnp.asarray(arg))
    out = getattr(tse3, fn)(_t(arg))
    np.testing.assert_allclose(_n(out), np.asarray(ref), atol=ATOL)


def test_se3_points_and_centers(rng):
    T, _ = _poses(rng, 8)
    pts = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _n(tse3.transform_points(_t(T), _t(pts))),
        np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))), atol=ATOL)
    np.testing.assert_allclose(
        _n(tse3.camera_center(_t(T))),
        np.asarray(jse3.camera_center(jnp.asarray(T))), atol=ATOL)
    np.testing.assert_allclose(
        _n(tse3.retract(_t(T), _t(pts.repeat(2, 1) * 0.1))),
        np.asarray(jse3.retract(jnp.asarray(T), jnp.asarray(pts.repeat(2, 1) * 0.1))),
        atol=ATOL)


def test_camera_parity(rng):
    intr = np.array([520.0, 515.0, 320.0, 240.0], np.float32)
    T, _ = _poses(rng, 1)
    pts = (rng.normal(size=(50, 3)) + [0, 0, 6]).astype(np.float32)
    uv_r, z_r = jcam.project(jnp.asarray(T[0]), jnp.asarray(pts), jnp.asarray(intr))
    uv_t, z_t = tcam.project(_t(T[0]), _t(pts), _t(intr))
    np.testing.assert_allclose(_n(uv_t), np.asarray(uv_r), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(_n(z_t), np.asarray(z_r), atol=ATOL)
    uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _n(tcam.pixel_to_normalized(_t(uv), _t(intr))),
        np.asarray(jcam.pixel_to_normalized(jnp.asarray(uv), jnp.asarray(intr))), atol=ATOL)
    np.testing.assert_allclose(
        _n(tcam.backproject(_t(uv), _t(pts[:, 2]), _t(intr))),
        np.asarray(jcam.backproject(jnp.asarray(uv), jnp.asarray(pts[:, 2]),
                                    jnp.asarray(intr))), atol=ATOL)
    np.testing.assert_allclose(
        _n(tcam.reprojection_error(_t(uv), _t(pts), _t(intr))),
        np.asarray(jcam.reprojection_error(jnp.asarray(uv), jnp.asarray(pts),
                                           jnp.asarray(intr))), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        _n(tcam.K_matrix(_t(intr))), np.asarray(jcam.K_matrix(jnp.asarray(intr))))


def test_linalg_parity(rng):
    A = rng.normal(size=(32, 12, 9)).astype(np.float32)
    AtA = np.einsum("bki,bkj->bij", A, A)
    v_r = np.asarray(jlin.smallest_eigvec(jnp.asarray(AtA)))
    v_t = _n(tlin.smallest_eigvec(_t(AtA)))
    np.testing.assert_allclose(v_t, v_r, atol=ATOL)
    M = rng.normal(size=(32, 3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(_n(tlin.inv3x3(_t(M))),
                               np.asarray(jlin.inv3x3(jnp.asarray(M))), rtol=1e-5, atol=ATOL)
    T, _ = _poses(rng, 8)
    noisy = T[:, :3, :3] + 0.01 * rng.normal(size=(8, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _n(tlin.orthonormalize_rotation(_t(noisy))),
        np.asarray(jlin.orthonormalize_rotation(jnp.asarray(noisy))), atol=ATOL)


def test_triangulation_parity(rng):
    T, _ = _poses(rng, 2)
    pts = (rng.normal(size=(64, 3)) + [0, 0, 8]).astype(np.float32)
    xy = []
    for k in range(2):
        pc = pts @ T[k, :3, :3].T + T[k, :3, 3]
        xy.append((pc[:, :2] / pc[:, 2:]).astype(np.float32))
    X_r = jtri.triangulate_dlt(jnp.asarray(T[0]), jnp.asarray(T[1]),
                               jnp.asarray(xy[0]), jnp.asarray(xy[1]))
    X_t = ttri.triangulate_dlt(_t(T[0]), _t(T[1]), _t(xy[0]), _t(xy[1]))
    np.testing.assert_allclose(_n(X_t), np.asarray(X_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        _n(ttri.triangulation_angle(_t(T[0]), _t(T[1]), X_t)),
        np.asarray(jtri.triangulation_angle(jnp.asarray(T[0]), jnp.asarray(T[1]), X_r)),
        atol=ATOL)
    np.testing.assert_array_equal(
        _n(ttri.is_positive_depth(_t(T[1]), X_t)),
        np.asarray(jtri.is_positive_depth(jnp.asarray(T[1]), X_r)))


def _up_to_sign(a, b, atol):
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < atol, (a, b)


def test_estimate_essential_parity(rng):
    uv1, uv2, mask, intr, _ = _two_view(rng)
    xy1 = np.asarray(jcam.pixel_to_normalized(jnp.asarray(uv1), jnp.asarray(intr)))
    xy2 = np.asarray(jcam.pixel_to_normalized(jnp.asarray(uv2), jnp.asarray(intr)))
    thr, n_hyp = 1.0 / intr[0], 128
    key = jax.random.PRNGKey(3)
    ref = jepi.estimate_essential(key, jnp.asarray(xy1), jnp.asarray(xy2),
                                  jnp.asarray(mask), thr, n_hyp=n_hyp)
    idx = jran.masked_sample_indices(key, jnp.asarray(mask), n_hyp, 8)
    out = tepi.estimate_essential(_t(xy1), _t(xy2), _t(mask), thr, n_hyp=n_hyp,
                                  sample_idx=_t(idx))
    np.testing.assert_array_equal(_n(out.inliers), np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers) > 100
    _up_to_sign(_n(out.model), np.asarray(ref.model), 1e-4)


def test_estimate_essential_batched_matches_single(rng):
    """Leading batch axes give the same answer as one problem at a time."""
    probs = [_two_view(np.random.default_rng(s)) for s in range(3)]
    xy1 = np.stack([(p[0] - p[3][2:]) / p[3][0] for p in probs]).astype(np.float32)
    xy2 = np.stack([(p[1] - p[3][2:]) / p[3][0] for p in probs]).astype(np.float32)
    mask = np.stack([p[2] for p in probs])
    idx = torch.stack([tran.masked_sample_indices(
        torch.Generator().manual_seed(s), _t(mask[s]), 64, 8) for s in range(3)])
    batched = tepi.estimate_essential(_t(xy1), _t(xy2), _t(mask), 0.002, 64,
                                      sample_idx=idx)
    for s in range(3):
        one = tepi.estimate_essential(_t(xy1[s]), _t(xy2[s]), _t(mask[s]), 0.002, 64,
                                      sample_idx=idx[s])
        np.testing.assert_array_equal(_n(batched.inliers[s]), _n(one.inliers))


def test_estimate_homography_parity(rng):
    uv1, uv2, mask, intr, _ = _two_view(rng, planar=True)
    n_hyp = 96
    key = jax.random.PRNGKey(5)
    ref = jhom.estimate_homography(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(mask), 4.0, n_hyp=n_hyp)
    idx = jran.masked_sample_indices(key, jnp.asarray(mask), n_hyp, 4)
    out = thom.estimate_homography(_t(uv1), _t(uv2), _t(mask), 4.0, n_hyp=n_hyp,
                                   sample_idx=_t(idx))
    np.testing.assert_array_equal(_n(out.inliers), np.asarray(ref.inliers))
    assert int(out.n_inliers) > 100
    _up_to_sign(_n(out.model), np.asarray(ref.model), 1e-4)

    Rs_r, ts_r, ns_r, _ = jhom.decompose_homography(ref.model, jnp.asarray(intr))
    Rs_t, ts_t, ns_t, _ = thom.decompose_homography(_t(np.asarray(ref.model)), _t(intr))
    # the SVD's sign conventions may differ between the two libraries; the
    # candidate SET is what the caller votes over
    for R in np.asarray(Rs_r):
        assert min(np.abs(R - Rt).max() for Rt in _n(Rs_t)) < 1e-3


def test_recover_pose_parity(rng):
    uv1, uv2, mask, intr, T_gt = _two_view(rng, outliers=0.0)
    xy1 = np.asarray(jcam.pixel_to_normalized(jnp.asarray(uv1), jnp.asarray(intr)))
    xy2 = np.asarray(jcam.pixel_to_normalized(jnp.asarray(uv2), jnp.asarray(intr)))
    E = np.asarray(jepi.eight_point(jnp.asarray(xy1), jnp.asarray(xy2), exact=True))
    T_r, n_r, good_r = jepi.recover_pose(jnp.asarray(E), jnp.asarray(xy1),
                                         jnp.asarray(xy2), jnp.asarray(mask))
    T_t, n_t, good_t = tepi.recover_pose(_t(E), _t(xy1), _t(xy2), _t(mask))
    np.testing.assert_allclose(_n(T_t), np.asarray(T_r), atol=1e-4)
    assert int(n_t) == int(n_r)
    np.testing.assert_array_equal(_n(good_t), np.asarray(good_r))
    np.testing.assert_allclose(_n(T_t)[:3, :3], T_gt[:3, :3], atol=5e-3)


@pytest.mark.parametrize("planar", [False, True])
def test_recover_pose_two_view_parity(rng, planar):
    """The E-vs-H rule end to end on the reference's sample indices: the
    same path, the same pose and the same surviving points (a 3-D scene
    takes the E path, a plane the H path; the H path needs H to explain
    85% of the matches, so the plane carries no outliers)."""
    from eacham_tpu.sfm import twoview as jtv
    from eacham_tpu_torch.sfm import twoview as ttv

    uv1, uv2, mask, intr, _ = _two_view(rng, planar=planar,
                                        outliers=0.0 if planar else 0.2)
    key = jax.random.PRNGKey(9)
    n_e, n_h, angle = 128, 64, np.deg2rad(1.0)
    ref = jtv.recover_pose_two_view(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                    jnp.asarray(mask), jnp.asarray(intr), 4.0, angle,
                                    n_hyp_e=n_e, n_hyp_h=n_h)
    ke, kh = jax.random.split(key)
    out = ttv.recover_pose_two_view(
        _t(uv1), _t(uv2), _t(mask), _t(intr), 4.0, angle, n_hyp_e=n_e, n_hyp_h=n_h,
        sample_idx_e=_t(jran.masked_sample_indices(ke, jnp.asarray(mask), n_e, 8)),
        sample_idx_h=_t(jran.masked_sample_indices(kh, jnp.asarray(mask), n_h, 4)))
    assert bool(out.used_homography) == bool(ref.used_homography) == planar
    assert int(out.n_good) == int(ref.n_good) > 100
    np.testing.assert_array_equal(_n(out.point_ok), np.asarray(ref.point_ok))
    np.testing.assert_allclose(_n(out.T), np.asarray(ref.T), atol=1e-3)
    ok = _n(out.point_ok)
    np.testing.assert_allclose(_n(out.points)[ok], np.asarray(ref.points)[ok],
                               rtol=1e-3, atol=1e-3)


def test_masked_sample_indices_respect_mask():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    idx = tran.masked_sample_indices(torch.Generator().manual_seed(0), mask, 200, 8)
    assert idx.shape == (200, 8)
    assert bool(mask[idx].all())
    assert all(len(set(r.tolist())) == 8 for r in idx)
