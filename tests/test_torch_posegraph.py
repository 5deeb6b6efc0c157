"""The port's pose graph (eacham_tpu_torch.sfm.posegraph) against the JAX
package's on inputs made from a seed with numpy (CPU).

The host solvers are the reference's numpy code, so they must agree to
1e-12. ``optimize_pose_graph`` takes fp32 poses in and gives fp32 poses out
with float64 inside; the camera centres it starts from are one fp32 einsum
in each package, so the poses are held to 1e-4. The measurements are
RANSAC: the port is handed the draws the reference made (``fold_in`` of
the key with the row), and then the weights (inlier counts) must be equal,
the rotations agree to 1e-3 and the PnP translations to the 5e-3 that
tests/test_torch_pnp.py explains. The data keep away from the inlier
thresholds (0.3 px noise against 4 px, outliers tens of pixels off)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.geometry.ransac import masked_sample_indices as jax_sample_indices
from eacham_tpu.geometry.se3 import exp_se3
from eacham_tpu.sfm import posegraph as jpg
from eacham_tpu.sfm import scene as jscene
from eacham_tpu_torch.sfm import posegraph as tpg
from eacham_tpu_torch.sfm import scene as tscene
from tests.test_posegraph import _centers, _edges_from_gt, _loop_pnp_setup, _orbit_poses
from tests.test_torch_triangulate import make_scene_np

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rotations(rng, n, scale):
    w = rng.normal(size=(n, 3)) * scale
    w[:3] *= 1e-9                 # the small-angle branches
    return w, jpg._exp_so3_np(w)


@pytest.mark.parametrize("name", ["_log_so3_np", "_exp_so3_np", "_hat_np", "_jr_inv_np"])
def test_so3_helpers_equal_the_reference(name):
    rng = np.random.default_rng(0)
    w, R = _rotations(rng, 64, 1.0)
    arg = R if name == "_log_so3_np" else w
    np.testing.assert_allclose(getattr(tpg, name)(arg), getattr(jpg, name)(arg),
                               rtol=0, atol=1e-12)


def test_sparse_assembly_and_solve_equal_the_reference():
    rng = np.random.default_rng(7)
    N, E = 30, 120
    ii = rng.integers(0, N, E)
    jj = (ii + 1 + rng.integers(0, N - 1, E)) % N
    B = rng.normal(size=(E, 3, 3))
    B = B @ np.swapaxes(B, 1, 2)
    out = {}
    for mod in (tpg, jpg):
        rows, cols, vals = [], [], []
        mod._block_triplets(ii, ii, B, rows, cols, vals)
        mod._block_triplets(jj, jj, B, rows, cols, vals)
        mod._block_triplets(ii, jj, -B, rows, cols, vals)
        mod._block_triplets(jj, ii, -np.swapaxes(B, 1, 2), rows, cols, vals)
        nid = np.arange(N)
        mod._block_triplets(nid, nid, np.tile(np.eye(3), (N, 1, 1)), rows, cols, vals)
        mod._block_triplets(nid, nid, np.ones((N, 1, 1)), rows, cols, vals, stride_r=1,
                            stride_c=1, off_r=3 * N, off_c=3 * N)
        b = np.arange(4 * N, dtype=np.float64)
        out[mod] = (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
                    mod._sparse_solve(rows, cols, vals, 4 * N, b))
    for a, b in zip(out[tpg], out[jpg]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_rotation_averaging_host_equals_the_reference():
    """The 60-frame drifted orbit of tests/test_posegraph.py (up to 34 deg
    of rotation drift), exact measurements plus three corrupted ones."""
    N = 60
    gt = _orbit_poses(N)
    rng = np.random.default_rng(1)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    drift = jpg._exp_so3_np((0.6 * (np.arange(N) / N) ** 2)[:, None] * axis[None])
    Rg = gt[:, :3, :3].astype(np.float64)
    R0 = drift @ Rg
    pairs = np.asarray([(i, i + 1) for i in range(N - 1)] + [(i, i + 4) for i in range(N - 4)]
                       + [(0, N - 1), (1, N - 1)], np.int32)
    R_meas = np.einsum("eab,ecb->eac", Rg[pairs[:, 1]], Rg[pairs[:, 0]])
    R_meas[[5, 30, 70]] = jpg._exp_so3_np(rng.normal(size=(3, 3)))
    sw = rng.uniform(0.5, 1.0, len(pairs))
    free = np.arange(N) > 0
    args = (R0, R_meas, pairs[:, 0], pairs[:, 1], sw, free)
    out = tpg._rotation_averaging_host(*args, rot_sigma=0.02, iters=20)
    ref = jpg._rotation_averaging_host(*args, rot_sigma=0.02, iters=20)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    assert np.abs(out - Rg).max() < 1e-3


def test_loop_consistency_equals_the_reference():
    """Random poses and loop measurements with pad rows and weights on
    both sides of the gate; tensors and arrays both accepted; +inf when no
    row passes the gate."""
    rng = np.random.default_rng(3)
    N, P, Pl = 20, 40, 16
    poses = np.asarray(jax.vmap(exp_se3)(jnp.asarray(rng.normal(size=(N, 6)) * 0.5)))
    pairs = np.sort(rng.integers(0, N, (P, 2)), axis=1).astype(np.int32)
    rows = rng.integers(-1, P, Pl).astype(np.int32)
    T_loop = np.asarray(jax.vmap(exp_se3)(jnp.asarray(rng.normal(size=(Pl, 6)) * 0.5)))
    w = rng.uniform(0, 100, Pl).astype(np.float32)
    ref = jpg.loop_consistency(jnp.asarray(poses), jnp.asarray(pairs), jnp.asarray(rows),
                               jnp.asarray(T_loop), jnp.asarray(w))
    for conv in (_t, np.asarray):
        out = tpg.loop_consistency(conv(poses), conv(pairs), conv(rows), conv(T_loop), conv(w))
        assert abs(out - ref) <= 1e-12 * max(1.0, abs(ref)), (out, ref)
    assert np.isinf(tpg.loop_consistency(poses, pairs, rows, T_loop, np.zeros_like(w)))
    np.testing.assert_allclose(tpg.centers_of(_t(poses)), jpg.centers_of(poses), atol=1e-12)


def _drifted_orbit():
    """tests/test_posegraph.py::test_pgo_recovers_drifted_loop's input."""
    N = 48
    gt = _orbit_poses(N)
    rng = np.random.default_rng(0)
    ramp = (np.arange(N, dtype=np.float32) / N) ** 2
    direction = rng.normal(size=6).astype(np.float32)
    direction *= np.array([0.12] * 3 + [1.2] * 3, np.float32) / max(
        np.linalg.norm(direction), 1e-9)
    drift = ramp[:, None] * direction[None, :]
    drift += rng.normal(scale=[2e-4] * 3 + [2e-3] * 3, size=(N, 6)).astype(np.float32)
    drift[0] = 0.0
    noisy = np.asarray(jax.vmap(exp_se3)(jnp.asarray(drift))) @ gt
    noisy[0] = gt[0]
    pairs = [(i, i + 1) for i in range(N - 1)]
    pairs += [(i, i + 3) for i in range(N - 3)]
    pairs += [(0, N - 1), (1, N - 1), (0, N - 2)]
    pairs = np.asarray(pairs, np.int32)
    fixed = np.arange(N) == 0
    return dict(poses=noisy, pose_valid=np.ones(N, bool), pose_fixed=fixed, pair_idx=pairs,
                T_meas=_edges_from_gt(gt, pairs), weight=np.full(len(pairs), 100.0, np.float32),
                iters=15), gt


def _invalid_and_weak():
    """tests/test_posegraph.py::test_pgo_ignores_invalid_and_weak_edges."""
    N = 8
    gt = _orbit_poses(N)
    pairs = np.asarray([(i, i + 1) for i in range(N - 1)] + [(2, 5)], np.int32)
    w = np.full(len(pairs), 100.0, np.float32)
    w[-1] = 1.0
    valid = np.ones(N, bool)
    valid[5] = False
    return dict(poses=gt, pose_valid=valid, pose_fixed=np.arange(N) == 0, pair_idx=pairs,
                T_meas=_edges_from_gt(gt, pairs), weight=w, iters=5), gt


def _pnp_loop():
    """tests/test_posegraph.py::test_pgo_with_pnp_loop_edges_and_gate, the
    loop measurement taken by the reference."""
    (gt, noisy, X_map, kps, intr, pairs, match, vmask, kp2lm, P, i, j) = _loop_pnp_setup()
    N = gt.shape[0]
    loop_rows = np.asarray([P - 1], np.int32)
    T_loop, w_loop = jpg.loop_pnp_measurements(
        jnp.asarray(noisy), jnp.asarray(X_map), jnp.ones(X_map.shape[0], bool),
        jnp.asarray(kp2lm), jnp.asarray(kps), jnp.asarray(pairs), jnp.asarray(match),
        jnp.asarray(vmask), intr, jnp.asarray(loop_rows), jax.random.PRNGKey(0))
    return dict(poses=noisy, pose_valid=np.ones(N, bool), pose_fixed=np.arange(N) == 0,
                pair_idx=pairs, T_meas=_edges_from_gt(gt, pairs),
                weight=np.full(P, 100.0, np.float32), iters=10, loop_rows=loop_rows,
                T_loop=np.asarray(T_loop), w_loop=np.asarray(w_loop)), gt


@pytest.mark.parametrize("case", [_drifted_orbit, _invalid_and_weak, _pnp_loop],
                         ids=["drifted_orbit", "invalid_and_weak", "pnp_loop"])
def test_optimize_pose_graph_matches_the_reference(case):
    """Poses within 1e-4 of the reference's, a tensor in the poses' dtype
    and on their device, and each scenario's own bounds from
    tests/test_posegraph.py."""
    kw, gt = case()
    ref = np.asarray(jpg.optimize_pose_graph(
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}))
    out = tpg.optimize_pose_graph(
        **{k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    out = out.numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    noisy = kw["poses"]
    if case is _drifted_orbit:
        from eacham_tpu_torch.utils.evaluate import align_umeyama

        def shape_err(T):
            s, R, t = align_umeyama(_centers(T), _centers(gt))
            return np.abs(s * _centers(T) @ R.T + t - _centers(gt)).max()

        assert shape_err(noisy) > 0.2
        assert shape_err(out) < 0.15 * shape_err(noisy)
        assert np.abs(out[:, :3, :3] - gt[:, :3, :3]).max() < 0.02
    elif case is _invalid_and_weak:
        valid = kw["pose_valid"]
        assert np.isfinite(out).all() and np.abs(out[valid] - gt[valid]).max() < 1e-3
        assert np.allclose(out[5], gt[5])
    else:
        args = (kw["pair_idx"], kw["loop_rows"], kw["T_loop"], kw["w_loop"])
        assert tpg.loop_consistency(out, *args) < tpg.loop_consistency(noisy, *args)
        err_b = np.abs(_centers(noisy) - _centers(gt)).max()
        assert np.abs(_centers(out) - _centers(gt)).max() < 0.5 * err_b


def test_optimize_pose_graph_without_live_edges_returns_the_poses():
    kw, _ = _invalid_and_weak()
    kw["weight"] = np.zeros_like(kw["weight"])
    out = tpg.optimize_pose_graph(**{k: (_t(v) if isinstance(v, np.ndarray) else v)
                                     for k, v in kw.items()})
    np.testing.assert_array_equal(out.numpy(), kw["poses"])


def _measurement_scene(seed=0, noise=0.3, outliers=0.15):
    """The 12-frame orbit of tests/test_posegraph.py around a cloud of 96
    points, without drift: every frame sees every point (slot k is point
    k), pixels with noise, a share of each edge's matches replaced by gross
    outliers, one edge dead, some landmarks invalid."""
    (gt, _, X_map, kps, intr, pairs, match, vmask, kp2lm, P, i, j) = _loop_pnp_setup(0.0)
    rng = np.random.default_rng(seed)
    N, K = kps.shape[:2]
    kps = (kps + rng.normal(scale=noise, size=kps.shape)).astype(np.float32)
    match = match.copy()
    for p in range(P):
        bad = np.flatnonzero(rng.random(K) < outliers)
        match[p, bad] = np.roll(match[p, bad], 1) if len(bad) > 1 else match[p, bad]
    pair_ok = np.ones(P, bool)
    pair_ok[2] = False
    vmask = vmask & (rng.random((P, K)) > 0.1)
    kp2lm = np.tile(np.arange(K, dtype=np.int32), (N, 1))
    lm_valid = rng.random(K) > 0.1
    return gt, X_map, kps, np.asarray(intr), pairs, pair_ok, match, vmask, kp2lm, lm_valid


def test_edge_measurements_match_the_reference_with_its_draws():
    gt, _, kps, intr, pairs, pair_ok, match, vmask, _, _ = _measurement_scene()
    n_hyp = 64
    key = jax.random.PRNGKey(4)
    T_ref, w_ref = jpg.edge_measurements(
        jnp.asarray(kps), jnp.asarray(pairs), jnp.asarray(pair_ok), jnp.asarray(match),
        jnp.asarray(vmask), jnp.asarray(intr), key, px_threshold=4.0, n_hyp=n_hyp, chunk=4)
    live = vmask & pair_ok[:, None]
    idx = np.stack([np.asarray(jax_sample_indices(jax.random.fold_in(key, r),
                                                  jnp.asarray(live[r]), n_hyp, 8))
                    for r in range(len(pairs))])
    T, w = tpg.edge_measurements(_t(kps), _t(pairs), _t(pair_ok), _t(match), _t(vmask),
                                 _t(intr), px_threshold=4.0, n_hyp=n_hyp, chunk=5,
                                 sample_idx=_t(idx))
    T_ref, w_ref = np.asarray(T_ref), np.asarray(w_ref)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    on = w_ref > 0
    assert on.sum() == len(pairs) - 1 and w_ref[2] == 0
    np.testing.assert_allclose(T.numpy()[on, :3, :3], T_ref[on, :3, :3], atol=1e-3)
    # the unit translation is the left null vector of E: the port refits the
    # winning E in fp64, the reference in fp32 (geometry/epipolar.py), and
    # at these short baselines the direction moves by up to 2.2e-3 (measured)
    np.testing.assert_allclose(T.numpy()[on, :3, 3], T_ref[on, :3, 3], atol=5e-3)
    # and against the ground truth: the unit direction of each relative pose
    rel = np.stack([gt[b] @ np.linalg.inv(gt[a]) for a, b in pairs])
    d = rel[:, :3, 3] / np.linalg.norm(rel[:, :3, 3], axis=-1, keepdims=True)
    assert np.abs(T.numpy()[on, :3, 3] - d[on]).max() < 0.05


def test_loop_pnp_measurements_match_the_reference_with_its_draws():
    gt, X, kps, intr, pairs, _, match, vmask, kp2lm, lm_valid = _measurement_scene(1)
    P = len(pairs)
    rows = np.asarray([P - 1, 0, -1, 4, 7, 3, P - 1, -1], np.int32)
    n_hyp = 64
    key = jax.random.PRNGKey(9)
    poses = gt
    T_ref, w_ref = jpg.loop_pnp_measurements(
        jnp.asarray(poses), jnp.asarray(X), jnp.asarray(lm_valid), jnp.asarray(kp2lm),
        jnp.asarray(kps), jnp.asarray(pairs), jnp.asarray(match), jnp.asarray(vmask),
        jnp.asarray(intr), jnp.asarray(rows), key, px_threshold=4.0, n_hyp=n_hyp)
    idx = []
    for pos, r in enumerate(rows):
        p = max(r, 0)
        lm = kp2lm[pairs[p, 0]]
        on = vmask[p] & (lm >= 0) & lm_valid[np.maximum(lm, 0)]
        idx.append(np.asarray(jax_sample_indices(jax.random.fold_in(key, pos),
                                                 jnp.asarray(on), n_hyp, 6)))
    T, w = tpg.loop_pnp_measurements(
        _t(poses), _t(X), _t(lm_valid), _t(kp2lm), _t(kps), _t(pairs), _t(match), _t(vmask),
        _t(intr), _t(rows), px_threshold=4.0, n_hyp=n_hyp, chunk=3,
        sample_idx=_t(np.stack(idx)))
    T_ref, w_ref = np.asarray(T_ref), np.asarray(w_ref)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    on = rows >= 0
    assert (w_ref[~on] == 0).all() and (w_ref[on] > 48).all()
    np.testing.assert_allclose(T.numpy()[on, :3, :3], T_ref[on, :3, :3], atol=1e-3)
    np.testing.assert_allclose(T.numpy()[on, :3, 3], T_ref[on, :3, 3], atol=5e-3)
    rel = np.stack([gt[pairs[r, 1]] @ np.linalg.inv(gt[pairs[r, 0]]) for r in rows[on]])
    assert np.abs(T.numpy()[on] - rel).max() < 5e-2


def test_loop_pnp_measurements_own_stream():
    """With the port's own draws, batched over the rows, every live row
    recovers the metric relative pose."""
    gt, X, kps, intr, pairs, _, match, vmask, kp2lm, lm_valid = _measurement_scene(2)
    rows = np.asarray([len(pairs) - 1, 1, 5, -1], np.int32)
    g = torch.Generator().manual_seed(0)
    T, w = tpg.loop_pnp_measurements(
        _t(gt), _t(X), _t(lm_valid), _t(kp2lm), _t(kps), _t(pairs), _t(match), _t(vmask),
        _t(intr), _t(rows), g, n_hyp=64)
    rel = np.stack([gt[pairs[r, 1]] @ np.linalg.inv(gt[pairs[r, 0]]) for r in rows[:3]])
    assert (w.numpy()[:3] > 48).all() and w.numpy()[3] == 0
    assert np.abs(T.numpy()[:3] - rel).max() < 5e-2


def test_rebuild_map_matches_the_reference():
    """One scene made with each package's make_scene from the same arrays
    (12 frames, 9 registered, the old landmark table left in place to be
    wiped): links and landmark flags equal, no link on a frame without a
    valid pose, points within 1e-4 of the reference's relative to their
    distance from the origin (~5 units: a two-view point at this baseline
    moves by 1.2e-4 between the packages' fp32 triangulations, measured)."""
    d, _ = make_scene_np(seed=4)
    N = d["kp_mask"].shape[0]
    names = ("keypoints", "kp_mask", "pair_idx", "pair_ok", "match_ij", "valid_ij",
             "match_ji", "valid_ji")
    js = jscene.make_scene(*(jnp.asarray(d[k]) for k in names), jnp.asarray(d["intr"]),
                           lm_capacity=256)
    ts = tscene.make_scene(*(_t(d[k]) for k in names), _t(d["intr"]), lm_capacity=256)
    state = {k: d[k] for k in ("pose", "pose_valid", "pose_fixed", "kp2lm", "points",
                               "lm_valid", "lm_two_view", "n_landmarks")}
    js = js._replace(**{k: jnp.asarray(v) for k, v in state.items()})
    ts = ts._replace(**{k: _t(v) for k, v in state.items()})
    fp = tscene.frame_pair_table(d["pair_idx"], N)
    np.testing.assert_array_equal(fp, jscene.frame_pair_table(d["pair_idx"], N))
    ref = jpg.rebuild_map(js, jnp.asarray(fp), 8.0, np.deg2rad(1.0), max_observers=6, segment=5)
    out = tpg.rebuild_map(ts, _t(fp), 8.0, np.deg2rad(1.0), max_observers=6, segment=5)
    for k in ("kp2lm", "lm_valid", "lm_two_view", "n_landmarks"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(ref, k)), k)
    on = out.lm_valid.numpy()
    p_out, p_ref = out.points.numpy()[on], np.asarray(ref.points)[on]
    scale = np.maximum(1.0, np.linalg.norm(p_ref, axis=-1, keepdims=True))
    assert (np.abs(p_out - p_ref) <= 1e-4 * scale).all(), np.abs(p_out - p_ref).max()
    kp2lm = out.kp2lm.numpy()
    assert on.sum() > 40 and int(out.n_landmarks) > 40
    assert (kp2lm[~d["pose_valid"]] < 0).all()
    assert not out.lm_two_view.any()
