"""The port's submap alignment (eacham_tpu_torch.sfm.submap) against the JAX
package's on the scenarios of tests/test_submap.py (CPU).

Both are the same host float64 numpy code, so the partition must be equal
and the aligned poses agree to 1e-9; each scenario also keeps that file's
own assertions, checked on the port's output with the port's
``loop_consistency`` and ``optimize_pose_graph``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eacham_tpu.sfm import posegraph as jpg
from eacham_tpu.sfm import submap as jsub
from eacham_tpu_torch.sfm import posegraph as tpg
from eacham_tpu_torch.sfm import submap as tsub
from tests.test_submap import _centers, _drifted, _loop_setup, _orbit_poses

torch.set_num_threads(2)


@pytest.mark.parametrize("size", [100, 37, 1000])
def test_split_submaps_equals_the_reference(size):
    rng = np.random.default_rng(size)
    for n in (1, 99, 300, 457):
        valid = rng.random(n) > 0.2
        valid[100:140] = False
        for a, b in zip(tsub.split_submaps(valid, size), jsub.split_submaps(valid, size)):
            np.testing.assert_array_equal(a, b)
    member, rep, ok = tsub.split_submaps(np.r_[np.ones(100), np.zeros(100), np.ones(100)]
                                         .astype(bool), 100)
    assert ok.tolist() == [True, False, True]


def _both(noisy, valid, fixed, pairs, loop_rows, T_loop, w_loop, size=50):
    out = tsub.submap_align(noisy, valid, fixed, pairs, loop_rows, T_loop, w_loop, size=size)
    ref = jsub.submap_align(noisy, valid, fixed, pairs, loop_rows, T_loop, w_loop, size=size)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    return out


def _consistency(poses, pairs, loop_rows, T_loop, w_loop):
    return tpg.loop_consistency(torch.as_tensor(poses), pairs, loop_rows, T_loop, w_loop)


def test_submap_align_repairs_large_drift():
    N = 600
    gt = _orbit_poses(N)
    noisy = _drifted(gt, rot_mag=0.5, trans_mag=3.0, seed=1)
    pairs, loop_rows, T_loop, w_loop = _loop_setup(N, noisy, gt)
    valid = np.ones(N, bool)
    fixed = np.arange(N) == 0
    err0 = _consistency(noisy, pairs, loop_rows, T_loop, w_loop)
    assert err0 > 20.0, err0
    out = _both(noisy, valid, fixed, pairs, loop_rows, T_loop, w_loop)
    err1 = _consistency(out, pairs, loop_rows, T_loop, w_loop)
    assert err1 < 0.2 * err0, (err0, err1)
    e0 = np.abs(_centers(noisy) - _centers(gt)).max()
    assert np.abs(_centers(out) - _centers(gt)).max() < 0.5 * e0
    assert np.abs(out[:, :3, :3] - gt[:, :3, :3]).max() < 0.25
    assert np.abs(out[0] - noisy[0]).max() < 1e-5
    # the composition with the frame pose graph, the port's against the reference's
    T_meas = np.stack([gt[j] @ np.linalg.inv(gt[i]) for i, j in pairs]).astype(np.float32)
    T_meas[:, :3, 3] /= np.maximum(np.linalg.norm(T_meas[:, :3, 3], axis=-1, keepdims=True),
                                   1e-9)
    w = np.full(len(pairs), 100.0, np.float32)
    args = (out, valid, fixed, pairs, T_meas, w)
    out2 = tpg.optimize_pose_graph(*(torch.as_tensor(a) for a in args), iters=12,
                                   loop_rows=torch.as_tensor(loop_rows),
                                   T_loop=torch.as_tensor(T_loop),
                                   w_loop=torch.as_tensor(w_loop)).numpy()
    ref2 = np.asarray(jpg.optimize_pose_graph(
        *(jnp.asarray(a) for a in args), iters=12, loop_rows=jnp.asarray(loop_rows),
        T_loop=jnp.asarray(T_loop), w_loop=jnp.asarray(w_loop)))
    np.testing.assert_allclose(out2, ref2, rtol=0, atol=1e-4)
    assert np.abs(_centers(out2) - _centers(gt)).max() < 0.2 * e0
    assert np.abs(out2[:, :3, :3] - gt[:, :3, :3]).max() < 5e-3


def test_submap_align_absorbs_scale_drift():
    N = 400
    gt = _orbit_poses(N)
    c = _centers(gt)
    ramp = 1.0 + 0.3 * (np.arange(N, dtype=np.float32) / N) ** 2
    c_s = c[0] + ramp[:, None] * (c - c[0])
    noisy = gt.copy()
    for n in range(N):
        noisy[n, :3, 3] = -gt[n, :3, :3] @ c_s[n]
    pairs, loop_rows, T_loop, w_loop = _loop_setup(N, noisy, gt, n_loops=8)
    out = _both(noisy, np.ones(N, bool), np.arange(N) == 0, pairs, loop_rows, T_loop, w_loop)
    e0 = np.abs(_centers(noisy) - _centers(gt)).max()
    assert np.abs(_centers(out) - _centers(gt)).max() < 0.35 * e0


def test_submap_align_noop_without_loops():
    N = 200
    gt = _orbit_poses(N)
    noisy = _drifted(gt, rot_mag=0.3, trans_mag=2.0, seed=2)
    pairs, loop_rows, T_loop, w_loop = _loop_setup(N, noisy, gt, n_loops=4)
    out = _both(noisy, np.ones(N, bool), np.eye(1, N, 0, dtype=bool)[0], pairs, loop_rows,
                T_loop, np.zeros_like(w_loop))
    assert np.allclose(out, noisy)


def test_submap_align_passes_invalid_through():
    N = 300
    gt = _orbit_poses(N)
    noisy = _drifted(gt, rot_mag=0.4, trans_mag=2.0, seed=3)
    valid = np.ones(N, bool)
    valid[40:70] = False
    garbage = noisy.copy()
    garbage[40:70] = 1e30
    pairs, loop_rows, T_loop, w_loop = _loop_setup(N, garbage, gt)
    out = _both(garbage, valid, np.arange(N) == 0, pairs, loop_rows, T_loop, w_loop)
    assert np.allclose(out[40:70], garbage[40:70])
    assert np.isfinite(out[valid]).all()
    e_raw = _consistency(garbage, pairs, loop_rows, T_loop, w_loop)
    e_out = _consistency(out, pairs, loop_rows, T_loop, w_loop)
    assert e_out < 0.75 * e_raw, (e_raw, e_out)
    e0 = np.abs(_centers(noisy[valid]) - _centers(gt[valid])).max()
    assert np.abs(_centers(out[valid]) - _centers(gt[valid])).max() < 1.3 * e0


def test_submap_align_on_neighbouring_rungs_equals_the_reference():
    """The edge shape of the 500-frame stress recipe: metric loop edges
    only at spans 20 and 40 (each joins two neighbouring submaps of 50
    frames) plus near revisits at the loop's end. The per-submap scales
    are then fixed by little more than their weak prior, and the alignment
    raises the loop inconsistency in both packages alike; the loop stage's
    gate (keep below 0.75x) rejects it."""
    N = 300
    gt = _orbit_poses(N)
    noisy = _drifted(gt, rot_mag=0.3, trans_mag=2.0, seed=4)
    pairs = [(i, i + 1) for i in range(N - 1)]
    loop_pairs = [(i, i + s) for s in (20, 40) for i in range(N - s)]
    loop_pairs += [(i, N - 5 + i) for i in range(5)]
    pairs = np.asarray(pairs + loop_pairs, np.int32)
    loop_rows = np.arange(N - 1, len(pairs), dtype=np.int32)
    T_loop = np.stack([gt[j] @ np.linalg.inv(gt[i]) for i, j in loop_pairs]).astype(np.float32)
    w_loop = np.full(len(loop_pairs), 100.0, np.float32)
    out = _both(noisy, np.ones(N, bool), np.arange(N) == 0, pairs, loop_rows, T_loop, w_loop)
    e0 = _consistency(noisy, pairs, loop_rows, T_loop, w_loop)
    e1 = _consistency(out, pairs, loop_rows, T_loop, w_loop)
    assert np.isfinite(out).all() and not e1 < 0.75 * e0, (e0, e1)
