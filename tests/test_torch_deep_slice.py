"""The port's deep-frontend slice as a whole, on the CPU at a small size:
images -> extract_deep_batch -> build_match_tables_deep ->
initialize_sfm(match_tables=...), held against the JAX package on the same
rendered frames (12 frames at 320x240, K = 384, pair_window 4, retrieval 2,
the shipped weights: the production-shape case of
tests/test_deep_pipeline.py).

The two packages' top-k may order two keypoints of nearly equal score
differently (tests/test_torch_deep.py), which permutes table columns, so
the candidate pairs and the match tables are compared on the reference's
features handed to both; the port's own chain then runs on its own RANSAC
draws.

Pose limits. The classical slice's limits (1 deg rotation, 5 deg
translation direction, tests/test_torch_slice.py) are out of reach of
either package at this size: on the port's verified tables of these frames
the reference's own two-view stage lands, over 8 seeds, on pair (0, 3) or
(1, 4); on the essential-matrix path 0.66 deg off in rotation and 20.5 deg
in translation direction, on the homography path (5 of 8 seeds) 3.5-5.9
deg and 105-128 deg; the port, same tables, 0.66 / 20.4 deg and 3.4-6.5 /
102-128 deg (scripts/init_pair_spread_{jax,torch}.py
--min-initial-inliers 50 --max-dim 320). The reference repairs this init
in bundle adjustment (its end-to-end test on these frames passes), which
the port does not have yet, so the init pair is held to the reference's
own spread: rotation under 1 deg and translation direction under 25 deg on
the essential path, rotation under 8 deg on the homography path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eacham_tpu.features.deep import frontend as jfe
from eacham_tpu.sfm.matches import candidate_pairs as jax_candidate_pairs
from eacham_tpu.utils.synthetic import render_sequence
from eacham_tpu_torch.features.deep import frontend as tfe
from eacham_tpu_torch.sfm import matches as tm
from eacham_tpu_torch.sfm import pipeline as tpipe
from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg

torch.set_num_threads(2)

N, W, H, K = 12, 320, 240, 384
WINDOW, RETRIEVAL, MIN_MATCHES = 4, 2, 15
OPTS = dict(min_initial_inliers=50, min_matches=MIN_MATCHES, init_min_tri_angle_deg=1.0,
            ransac_hyps_e=256, ransac_hyps_h=128, init_chunk=4)
MAX_ROT_DEG_E, MAX_TRANS_DEG_E, MAX_ROT_DEG_H = 1.0, 25.0, 8.0


@pytest.fixture(scope="module")
def world():
    images, poses, intr = render_sequence(np.random.default_rng(6), n_frames=N,
                                          width=W, height=H)
    return images.astype(np.float32), poses, np.asarray(intr, np.float32)


@pytest.fixture(scope="module")
def jax_chain(world):
    """Reference features and its match tables before verification."""
    images, _, _ = world
    sp_params, lg_params, n_layers = jfe.load_frontend_params()
    xy, desc, _, mask = jfe.extract_deep_batch(sp_params, jnp.asarray(images), max_keypoints=K)
    tables = jfe.build_match_tables_deep(
        lg_params, xy, desc, mask, (W, H), n_layers=n_layers, min_matches=MIN_MATCHES,
        pair_window=WINDOW, retrieval_k=RETRIEVAL, verify=None)
    # copies: arrays viewed from JAX buffers are read-only, which torch warns about
    return dict(xy=np.array(xy), desc=np.array(desc), mask=np.array(mask),
                tables=[np.asarray(t) for t in tables])


@pytest.fixture(scope="module")
def port_models():
    superpoint, matcher, _ = tfe.load_frontend_params(device="cpu")
    return superpoint, matcher


@pytest.fixture(scope="module")
def port_features(world, port_models):
    return tfe.extract_deep_batch(port_models[0], world[0], max_keypoints=K, device="cpu")


def test_candidate_pairs_agree(jax_chain, port_features):
    """Same descriptors in, same pair set out; and the port's own features
    select the same pairs (the retrieval similarities of these frames have
    no near-ties)."""
    ref = jax_candidate_pairs(jnp.asarray(jax_chain["desc"]), jnp.asarray(jax_chain["mask"]),
                              window=WINDOW, retrieval_k=RETRIEVAL)
    same = tm.candidate_pairs(torch.as_tensor(jax_chain["desc"]),
                              torch.as_tensor(jax_chain["mask"]),
                              window=WINDOW, retrieval_k=RETRIEVAL)
    np.testing.assert_array_equal(same, ref)
    assert same.dtype == np.int32 and len(ref) < N * (N - 1) // 2
    _, desc, _, mask = port_features
    np.testing.assert_array_equal(
        tm.candidate_pairs(desc, mask, window=WINDOW, retrieval_k=RETRIEVAL), ref)
    np.testing.assert_array_equal(tm.candidate_pairs(desc, mask, window=0),
                                  tm.all_pairs_index(N))


def test_match_tables_agree_before_verification(jax_chain, port_models):
    """On the reference's features: the same bucketed pair rows, entries of
    ``valid_ij`` agreeing on >= 0.99 (assignment scores differ by ~1e-5, so
    a score at the threshold may flip), equal matches where both are valid,
    and inverse tables consistent with the forward ones."""
    pair_ref, ok_ref, mij_ref, vij_ref, _, _ = jax_chain["tables"]
    pair_idx, pair_ok, m_ij, v_ij, m_ji, v_ji = tfe.build_match_tables_deep(
        port_models[1], jax_chain["xy"], jax_chain["desc"], jax_chain["mask"], (W, H),
        min_matches=MIN_MATCHES, pair_window=WINDOW, retrieval_k=RETRIEVAL, verify=None,
        device="cpu")
    np.testing.assert_array_equal(pair_idx.numpy(), pair_ref)
    assert pair_idx.shape[0] % 64 == 0
    np.testing.assert_array_equal(pair_ok.numpy(), ok_ref)
    assert ok_ref.sum() >= 10
    assert (v_ij.numpy() == vij_ref).mean() >= 0.99
    both = v_ij.numpy() & vij_ref
    assert both.sum() > 1000
    np.testing.assert_array_equal(m_ij.numpy()[both], mij_ref[both])
    p, k = np.nonzero(v_ij.numpy())
    assert np.all(m_ji.numpy()[p, m_ij.numpy()[p, k]] == k) and v_ji.sum() == v_ij.sum()
    assert not v_ij[~pair_ok].any()


@pytest.fixture(scope="module")
def port_tables(world, port_models, port_features):
    _, _, intr = world
    xy, desc, _, mask = port_features
    opt = tpipe.SfmOptions(**OPTS)
    return tfe.build_match_tables_deep(
        port_models[1], xy, desc, mask, (W, H), min_matches=MIN_MATCHES,
        pair_window=WINDOW, retrieval_k=RETRIEVAL, device="cpu",
        verify=(intr, torch.Generator().manual_seed(1), opt.max_repr_error, opt.verify_hyps))


def _check_init(stats, poses):
    assert stats["initialized"] and stats["n_good"] > OPTS["min_initial_inliers"]
    i0, j0 = stats["init_pair"]
    rot, trans = relative_pose_error_deg(stats["T_init"].numpy(), poses[i0], poses[j0])
    print(f"init pair ({i0}, {j0}), n_good {stats['n_good']}, homography "
          f"{stats['used_homography']}, rotation error {rot:.4f} deg, translation "
          f"direction error {trans:.4f} deg")
    assert j0 - i0 <= WINDOW
    if stats["used_homography"]:
        assert rot < MAX_ROT_DEG_H, (rot, trans)
    else:
        assert rot < MAX_ROT_DEG_E and trans < MAX_TRANS_DEG_E, (rot, trans)


def test_initialize_sfm_on_the_deep_six_tuple(world, port_features, port_tables):
    """The port's own chain: the 6-tuple goes in as it is and yields an
    init pair within the reference's spread on the port's own RANSAC draws."""
    _, poses, intr = world
    xy, desc, _, mask = port_features
    scene, stats = tpipe.initialize_sfm(xy, desc, mask, (W, H), intr=intr,
                                        options=tpipe.SfmOptions(**OPTS), device="cpu",
                                        match_tables=port_tables)
    assert stats["pairs"] == port_tables[0].shape[0] and stats["edges"] >= 10
    assert torch.equal(scene.valid_ij, port_tables[3])
    _check_init(stats, poses)
    assert int(scene.n_landmarks) == stats["n_good"]


def test_initialize_sfm_on_a_three_tuple_over_all_pairs(world, port_models, port_features):
    """``(match_ij, valid_ij, pair_ok)`` over all pairs is verified by
    initialize_sfm itself (verify_hyps > 0) and inverted."""
    _, poses, intr = world
    xy, desc, _, mask = port_features
    pairs = torch.as_tensor(tm.all_pairs_index(N))
    tables = tfe.match_all_pairs_deep(port_models[1], xy, desc, mask, pairs, (W, H),
                                      min_matches=MIN_MATCHES)
    scene, stats = tpipe.initialize_sfm(xy, desc, mask, (W, H), intr=intr,
                                        options=tpipe.SfmOptions(**OPTS), device="cpu",
                                        match_tables=tables)
    assert stats["pairs"] == N * (N - 1) // 2
    assert int(scene.valid_ij.sum()) <= int(tables[1].sum())      # verification only cuts
    assert not scene.valid_ij[~scene.pair_ok].any()
    _check_init(stats, poses)
    with pytest.raises(ValueError):
        tpipe.initialize_sfm(xy, desc, mask, (W, H), device="cpu", match_tables=tables[:2])


def test_initialize_sfm_with_a_pair_window(world, port_features):
    """``pair_window > 0`` sends the built-in matcher over the candidate
    pairs only."""
    _, poses, intr = world
    xy, desc, _, mask = port_features
    opt = tpipe.SfmOptions(**OPTS, pair_window=WINDOW, pair_retrieval_k=RETRIEVAL)
    scene, stats = tpipe.initialize_sfm(xy, desc, mask, (W, H), intr=intr, options=opt,
                                        device="cpu")
    cand = tm.candidate_pairs(desc, mask, window=WINDOW, retrieval_k=RETRIEVAL)
    np.testing.assert_array_equal(scene.pair_idx.numpy(), tm.bucket_pairs(cand))
    assert stats["pairs"] == 64 and stats["edges"] > 0
