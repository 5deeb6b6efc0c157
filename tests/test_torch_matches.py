"""Parity of the port's match graph (eacham_tpu_torch.sfm.matches) with the
JAX package on the CPU.

The frames are synthetic: 3-D points projected into five cameras, each
keypoint carrying its point's descriptor plus noise, with distractor
keypoints and a share of matches moved off their epipolar lines so that
verification has work to do. The port's RANSAC is handed the indices the
JAX package drew for each pair row (``fold_in(key, row)``), so both sides
must keep exactly the same matches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.features.matching import match_all_pairs as jax_match_all_pairs
from eacham_tpu.geometry.ransac import masked_sample_indices as jax_sample_indices
from eacham_tpu.sfm import matches as jm
from eacham_tpu_torch.sfm import matches as tm

torch.set_num_threads(2)

N, K, M, D = 5, 128, 100, 256
RATIO, MIN_MATCHES, N_HYP, PX = 0.8, 20, 32, 4.0


def _sampson_px(R, t, uv1, uv2, intr):
    """Ground-truth Sampson distance in pixels of pixel pairs [M, 2]."""
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    p1 = np.c_[(uv1 - intr[2:]) / intr[:2], np.ones(len(uv1))]
    p2 = np.c_[(uv2 - intr[2:]) / intr[:2], np.ones(len(uv2))]
    Ep1, Etp2 = p1 @ E.T, p2 @ E
    num = np.abs(np.sum(p2 * Ep1, -1))
    return intr[0] * num / np.sqrt(Ep1[:, 0] ** 2 + Ep1[:, 1] ** 2
                                   + Etp2[:, 0] ** 2 + Etp2[:, 1] ** 2)


def _frames(seed=0):
    """keypoints [N, K, 2], descriptors [N, K, D], mask [N, K], intr [4].

    Each point is moved off its epipolar lines in at most one frame, and
    only where it lands at least 3x the RANSAC threshold from the line in
    every pair: no match sits near the threshold, where the two packages'
    fp32 hypotheses (equal to ~1e-4) could rank it differently."""
    rng = np.random.default_rng(seed)
    f, w, h = 300.0, 320.0, 240.0
    intr = np.array([f, f, w / 2, h / 2], np.float32)
    pts = np.c_[rng.uniform(-2, 2, (M, 2)), rng.uniform(4, 9, M)]
    pdesc = rng.normal(size=(M, D))
    Rs, ts, uvs = [], [], []
    for n in range(N):
        a = np.deg2rad(3.0 * n)
        Rs.append(np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                            [np.sin(a), 0, np.cos(a)]]))
        ts.append(np.array([0.25 * n, 0.02 * n, 0.05 * n]))
        pc = pts @ Rs[n].T + ts[n]
        uvs.append(f * pc[:, :2] / pc[:, 2:] + intr[2:])
    owner = rng.integers(0, N, M)                       # the one frame a point may move in
    for p in np.flatnonzero(rng.random(M) < 0.12):
        n = owner[p]
        moved = uvs[n][p] + rng.uniform(-40, 40, 2)
        far = True
        for m in range(N):
            if m == n:
                continue
            R = Rs[m] @ Rs[n].T                          # frame n -> frame m
            t = ts[m] - R @ ts[n]
            far &= _sampson_px(R, t, moved[None], uvs[m][p][None], intr)[0] > 3 * PX
        if far:
            uvs[n][p] = moved
    xy = np.zeros((N, K, 2), np.float32)
    desc = np.zeros((N, K, D), np.float32)
    for n in range(N):
        uv = uvs[n]
        d = pdesc + 0.02 * rng.normal(size=(M, D))
        extra = K - M                                    # distractors
        uv = np.concatenate([uv, rng.uniform([0, 0], [w, h], (extra, 2))])
        d = np.concatenate([d, rng.normal(size=(extra, D))])
        perm = rng.permutation(K)
        xy[n] = uv[perm]
        desc[n] = d[perm]
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = rng.random((N, K)) > 0.05
    return xy, desc, mask, intr


@pytest.fixture(scope="module")
def frames():
    return _frames()


def _jax_sample_idx(key, valid, n_hyp):
    """The indices JAX's verify_matches_epipolar draws for each pair row."""
    rows = jnp.arange(valid.shape[0], dtype=jnp.int32)
    return np.array(jax.vmap(
        lambda r, v: jax_sample_indices(jax.random.fold_in(key, r), v, n_hyp, 8))(
            rows, jnp.asarray(valid)))


def test_all_pairs_and_bucketing_match_the_reference():
    for n in (2, 5, 12, 46, 100):
        np.testing.assert_array_equal(tm.all_pairs_index(n), jm.all_pairs_index(n))
    pi = tm.bucket_pairs(tm.all_pairs_index(100))
    assert pi.shape == (5120, 2) and not pi[4950:].any()
    assert tm.bucket_pairs(tm.all_pairs_index(5)).shape == (64, 2)


def test_invert_matches_exact():
    rng = np.random.default_rng(3)
    P, Kk = 6, 50
    m = np.stack([rng.permutation(Kk) for _ in range(P)]).astype(np.int32)
    v = rng.random((P, Kk)) > 0.3
    m_r, v_r = jm.invert_matches(jnp.asarray(m), jnp.asarray(v))
    m_t, v_t = tm.invert_matches(torch.as_tensor(m), torch.as_tensor(v))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_r))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))


def test_verify_matches_epipolar_parity(frames):
    """Fed the same match tables and the reference's sample indices, the
    port keeps exactly the reference's matches."""
    xy, desc, mask, intr = frames
    pair_idx = jm.all_pairs_index(N)
    mj, mv, _ = jax_match_all_pairs(jnp.asarray(desc), jnp.asarray(mask),
                                    jnp.asarray(pair_idx), ratio=RATIO,
                                    min_matches=MIN_MATCHES)
    key = jax.random.PRNGKey(7)
    ref = jm.verify_matches_epipolar(jnp.asarray(xy), jnp.asarray(pair_idx), mj, mv,
                                     jnp.asarray(intr), key, px_threshold=PX,
                                     n_hyp=N_HYP, chunk=4)
    idx = _jax_sample_idx(key, mv, N_HYP)
    out = tm.verify_matches_epipolar(
        torch.as_tensor(xy), torch.as_tensor(pair_idx), torch.as_tensor(np.array(mj)),
        torch.as_tensor(np.array(mv)), torch.as_tensor(intr), px_threshold=PX,
        n_hyp=N_HYP, chunk=3, sample_idx=torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # verification has cut the moved matches and kept the rest
    assert 0 < int(out.sum()) < int(np.asarray(mv).sum())


def test_build_match_tables_parity(frames):
    """Matching, verification, the survivor gate and the inverse tables
    end to end: equal pair_ok and valid tables, equal match_j where valid."""
    xy, desc, mask, intr = frames
    key = jax.random.PRNGKey(11)
    ref = jm.build_match_tables(
        jnp.asarray(desc), jnp.asarray(mask), ratio=RATIO, min_matches=MIN_MATCHES,
        chunk=8, verify=(jnp.asarray(xy), jnp.asarray(intr), key, PX, N_HYP))
    pi_r, ok_r, mij_r, vij_r, mji_r, vji_r = (np.asarray(a) for a in ref)
    # the reference's pre-verification tables, for its per-row sample indices
    _, mv, _ = jax_match_all_pairs(jnp.asarray(desc), jnp.asarray(mask),
                                   jnp.asarray(pi_r), ratio=RATIO,
                                   min_matches=MIN_MATCHES, chunk=8)
    idx = torch.as_tensor(_jax_sample_idx(key, mv, N_HYP))
    out = tm.build_match_tables(
        torch.as_tensor(desc), torch.as_tensor(mask), ratio=RATIO,
        min_matches=MIN_MATCHES, chunk=8,
        verify=(torch.as_tensor(xy), torch.as_tensor(intr), None, PX, N_HYP),
        verify_sample_idx=idx)
    pi, ok, mij, vij, mji, vji = (a.numpy() for a in out)
    np.testing.assert_array_equal(pi, pi_r)
    np.testing.assert_array_equal(ok, ok_r)
    assert ok.sum() == N * (N - 1) // 2          # every real pair survives
    np.testing.assert_array_equal(vij, vij_r)
    np.testing.assert_array_equal(mij[vij], mij_r[vij_r])
    np.testing.assert_array_equal(vji, vji_r)
    np.testing.assert_array_equal(mji[vji], mji_r[vji_r])


def test_post_verify_gate():
    valid = torch.zeros(3, 40, dtype=torch.bool)
    valid[0, :25] = True
    valid[1, :20] = True
    valid[2, :30] = True
    ok, v = tm._post_verify_gate(torch.tensor([True, True, False]), valid, 20)
    assert ok.tolist() == [True, False, False]
    assert int(v.sum()) == 25 and bool(v[0, :25].all())


@pytest.mark.parametrize("n", [5, 12])
def test_pair_tables_match_the_reference(n):
    """The host-side lookup tables of sfm/scene.py, bucket rows included."""
    from eacham_tpu.sfm import scene as jscene
    from eacham_tpu_torch.sfm import scene as tscene

    pi = tm.bucket_pairs(tm.all_pairs_index(n))
    np.testing.assert_array_equal(tscene.pair_id_table(pi, n),
                                  jscene.pair_id_table(pi, n))
    np.testing.assert_array_equal(tscene.frame_pair_table(pi, n),
                                  jscene.frame_pair_table(pi, n))
