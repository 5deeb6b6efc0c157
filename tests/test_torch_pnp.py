"""The port's PnP (eacham_tpu_torch.geometry.pnp) and consensus
triangulation (geometry.triangulation.triangulate_consensus) against the
JAX package on inputs made from a seed with numpy (CPU).

Torch cannot reproduce JAX's random stream, so the port's RANSAC is handed
the hypothesis sample indices the reference drew; with those the inlier
masks must be equal and the poses agree to 5e-3 (why not finer is told at
the tests). The data keep away from
the inlier threshold (noise 0.3 px against 4 px, outliers tens of pixels
off): at the threshold the two packages' 1e-4 differences may flip a
point."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.geometry import pnp as jpnp
from eacham_tpu.geometry import ransac as jran
from eacham_tpu.geometry import triangulation as jtri
from eacham_tpu_torch.geometry import pnp as tpnp
from eacham_tpu_torch.geometry import triangulation as ttri
from tests.conftest import make_synthetic_scene

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pnp_problem(seed, n_pts=160, outliers=0.25, behind=5):
    """One camera of the synthetic ring: world points, noisy pixels, a
    quarter of them gross outliers, some slots masked, a few points moved
    behind the camera with pixels that would fit in front."""
    rng = np.random.default_rng(seed)
    poses, pts, intr, uv = make_synthetic_scene(rng, n_cams=3, n_pts=n_pts, noise=0.3)
    T, uv = poses[2], uv[2].copy()
    bad = rng.random(n_pts) < outliers
    uv[bad] += rng.uniform(30, 120, size=(int(bad.sum()), 2)) * rng.choice([-1, 1], size=(int(bad.sum()), 2))
    pts = pts.copy()
    # mirrored through the camera centre: same pixel, negative depth
    c = -T[:3, :3].T @ T[:3, 3]
    pts[:behind] = 2 * c - pts[:behind]
    mask = rng.random(n_pts) > 0.1
    return (pts.astype(np.float32), uv.astype(np.float32), mask,
            intr.astype(np.float32), T, bad)


def test_dlt_pnp_matches_reference(rng):
    """In fp32 the 12x12 DLT problem is ill-conditioned in both packages: on
    the same exact 12-point samples each lands up to 0.2 from the pose, and
    as far from the other (measured; on minimal 6-point samples worse), so
    hypotheses cannot be compared one by one at a fine tolerance. What is
    held: the port's algorithm in fp64 recovers the pose (1e-4, both
    forms); in fp32 the exact form agrees with the reference's to 2e-3 on
    40-point samples; and over a batch of 12-point samples the port's
    per-hypothesis form is as close to the pose as the reference's (medians
    within a factor of 3)."""
    pts, _, _, intr, T, _ = _pnp_problem(0, outliers=0.0, behind=0)
    pc = pts @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32)
    xy = (pc[:, :2] / pc[:, 2:]).astype(np.float32)

    def samples(size, n):
        return np.stack([rng.choice(len(pts), size=size, replace=False) for _ in range(n)])

    idx = samples(12, 16)
    for exact in (False, True):
        out = tpnp.dlt_pnp(_t(pts)[idx].double(), _t(xy)[idx].double(), exact=exact).numpy()
        np.testing.assert_allclose(out, np.broadcast_to(T, out.shape), atol=1e-4)
    idx40 = samples(40, 8)
    ref = np.stack([np.asarray(jpnp.dlt_pnp(jnp.asarray(pts[i]), jnp.asarray(xy[i]), exact=True))
                    for i in idx40])
    out = tpnp.dlt_pnp(_t(pts)[idx40], _t(xy)[idx40], exact=True).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-3)
    ref = np.stack([np.asarray(jpnp.dlt_pnp(jnp.asarray(pts[i]), jnp.asarray(xy[i])))
                    for i in idx])
    out = tpnp.dlt_pnp(_t(pts)[idx], _t(xy)[idx]).numpy()
    e_ref = np.median(np.abs(ref - T).max(axis=(1, 2)))
    e_out = np.median(np.abs(out - T).max(axis=(1, 2)))
    assert e_out < 3 * e_ref + 1e-4 and e_out < 0.05, (e_out, e_ref)


def test_gauss_newton_pose_matches_reference():
    pts, uv, mask, intr, T, bad = _pnp_problem(1, behind=0)
    w = (mask & ~bad).astype(np.float32)
    T0 = T.astype(np.float32).copy()
    T0[:3, 3] += np.array([0.05, -0.03, 0.08], np.float32)
    ref = jpnp.gauss_newton_pose(jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv),
                                 jnp.asarray(intr), jnp.asarray(w))
    out = tpnp.gauss_newton_pose(_t(T0), _t(pts), _t(uv), _t(intr), _t(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(out.numpy(), T, atol=5e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_pnp_ransac_matches_reference_with_its_sample_indices(seed):
    """Equal inlier masks and counts; behind-camera points are never
    inliers. Poses agree to 5e-3, with each other and with the ground
    truth: the two packages' winning hypotheses differ by the fp32
    conditioning of the DLT (see above), and the ten Gauss-Newton steps of
    the polish bring them together only that far (measured 3e-4 to 4e-3)."""
    pts, uv, mask, intr, T, bad = _pnp_problem(seed)
    n_hyp = 96
    key = jax.random.PRNGKey(seed)
    T_ref, inl_ref, n_ref = jpnp.solve_pnp_ransac(
        key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(intr),
        threshold=4.0, n_hyp=n_hyp)
    idx = jran.masked_sample_indices(key, jnp.asarray(mask), n_hyp, 6)
    T_out, inl, n = tpnp.solve_pnp_ransac(_t(pts), _t(uv), _t(mask), _t(intr),
                                          threshold=4.0, n_hyp=n_hyp, sample_idx=_t(idx))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_ref))
    assert int(n) == int(n_ref) > 80
    np.testing.assert_allclose(T_out.numpy(), np.asarray(T_ref), atol=5e-3)
    np.testing.assert_allclose(T_out.numpy(), T, atol=5e-3)
    assert not inl.numpy()[:5].any() and not inl.numpy()[~mask].any()


def test_solve_pnp_ransac_own_stream_and_dead_mask():
    """With the port's own draws the pose is still the ground truth; an
    all-False mask gives 0 inliers and finite values."""
    pts, uv, mask, intr, T, _ = _pnp_problem(3)
    g = torch.Generator().manual_seed(0)
    T_out, inl, n = tpnp.solve_pnp_ransac(_t(pts), _t(uv), _t(mask), _t(intr), n_hyp=128,
                                          generator=g)
    np.testing.assert_allclose(T_out.numpy(), T, atol=5e-3)
    assert int(n) > 80
    _, inl0, n0 = tpnp.solve_pnp_ransac(_t(pts), _t(uv), _t(np.zeros_like(mask)), _t(intr),
                                        n_hyp=16, generator=g)
    assert int(n0) == 0 and not inl0.any()


def _tracks(seed, n_tracks=64, V=5):
    """[n_tracks] tracks of up to V observers of the synthetic ring: noisy
    pixels, random observer masks (0 to V live), some observers replaced by
    gross outliers, some tracks seen by nearly coincident cameras."""
    rng = np.random.default_rng(seed)
    poses, pts, intr, uv = make_synthetic_scene(rng, n_cams=V, n_pts=n_tracks, noise=0.3)
    T = np.broadcast_to(poses[None], (n_tracks, V, 4, 4)).copy()
    T[::7, 1] = T[::7, 0]                      # zero baseline between slots 0 and 1
    T[::7, 1, 0, 3] += 1e-4
    uvt = uv.transpose(1, 0, 2).copy()         # [n_tracks, V, 2]
    uvt[::7, 1] = uvt[::7, 0]
    out = rng.random((n_tracks, V)) < 0.1
    uvt[out] += 60.0
    mask = rng.random((n_tracks, V)) > 0.3
    mask[:4] = False
    mask[4:10] = False
    mask[4:10, :2] = True                      # two-observer tracks
    return T.astype(np.float32), uvt.astype(np.float32), mask, intr.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_consensus_matches_reference(seed):
    """The batched port against the reference vmapped over tracks: equal
    ``ok`` and inlier masks, points 1e-4 where ok (relative to depth 5)."""
    T, uv, mask, intr = _tracks(seed)
    ang = float(np.deg2rad(1.0))
    ref = jax.vmap(lambda a, b, c: jtri.triangulate_consensus(
        a, b, c, jnp.asarray(intr), 4.0, ang))(jnp.asarray(T), jnp.asarray(uv),
                                               jnp.asarray(mask))
    pts, inl, ok = ttri.triangulate_consensus(_t(T), _t(uv), _t(mask), _t(intr), 4.0, ang)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[2]))
    okn = ok.numpy()
    assert okn.sum() > 20 and (~okn).sum() >= 6
    np.testing.assert_array_equal(inl.numpy()[okn], np.asarray(ref[1])[okn])
    np.testing.assert_allclose(pts.numpy()[okn], np.asarray(ref[0])[okn], atol=5e-4)


def test_triangulate_consensus_first_proposal_wins_ties():
    """Exact observations: every admissible pair proposes the same point
    with the same support, and the first pair in row-major order must be
    taken, as the reference's argmax does."""
    rng = np.random.default_rng(5)
    poses, pts, intr, uv = make_synthetic_scene(rng, n_cams=4, n_pts=16, noise=0.0)
    T = np.broadcast_to(poses[None], (16, 4, 4, 4)).astype(np.float32)
    uvt = uv.transpose(1, 0, 2).astype(np.float32)
    mask = np.ones((16, 4), bool)
    intr = intr.astype(np.float32)
    ref = jax.vmap(lambda a, b, c: jtri.triangulate_consensus(
        a, b, c, jnp.asarray(intr), 4.0, 0.01))(jnp.asarray(T), jnp.asarray(uvt),
                                                jnp.asarray(mask))
    out = ttri.triangulate_consensus(_t(T), _t(uvt), _t(mask), _t(intr), 4.0, 0.01)
    assert out[2].all() and out[1].all()
    # the first pair's own DLT point, to fp32 round-off of that one solve
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=2e-5)
    np.testing.assert_allclose(out[0].numpy(), pts, atol=1e-3)
