"""The port's first slice as a whole: images -> features -> verified match
graph -> init pair -> seeded two-view map, held against the JAX chain on
the same rendered frames (CPU, small size).

The frames are every 6th frame of the bench's orbit (bench.py), at the
bench's 512x384: at lower resolutions the blob keypoints are too noisy
for either package to recover the init pair's translation direction to
within 5 degrees."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.features.frontend import extract_features as jax_extract
from eacham_tpu.sfm import pipeline as jpipe
from eacham_tpu.sfm.matches import build_match_tables as jax_build_match_tables
from eacham_tpu.sfm.scene import make_scene as jax_make_scene
from eacham_tpu.sfm.twoview import find_best_pair as jax_find_best_pair
from eacham_tpu.utils.synthetic import make_blob_scene, orbit_poses, render_view
from eacham_tpu_torch import convert
from eacham_tpu_torch.features.frontend import extract_features
from eacham_tpu_torch.sfm import pipeline as tpipe
from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg

torch.set_num_threads(2)

N, W, H, K, STRIDE = 8, 512, 384, 256, 6
OPTS = dict(min_initial_inliers=40, min_matches=20, match_ratio=0.85,
            init_min_tri_angle_deg=1.0, ransac_hyps_e=128, ransac_hyps_h=64,
            init_chunk=4)
MAX_ROT_DEG, MAX_TRANS_DEG = 1.0, 5.0


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = make_blob_scene(rng, n_blobs=900, depth=(3.5, 9.0), spread=2.6)
    poses = orbit_poses(N * STRIDE, radius=0.6, step_deg=0.5, advance=0.03)[::STRIDE]
    images = np.stack([render_view(blobs, T, intr, W, H) for T in poses])
    return images, poses, intr


@pytest.fixture(scope="module")
def jax_chain(frames):
    """extract -> build_match_tables(verify) -> make_scene ->
    rank_init_pairs -> find_best_pair -> seed_initial_pair, as run_sfm."""
    images, _, intr = frames
    opt = jpipe.SfmOptions(**OPTS)
    xy, desc, _, mask = jax_extract(jnp.asarray(images), max_keypoints=K)
    key = jax.random.PRNGKey(opt.seed)
    key, k_ver = jax.random.split(key)
    tables = jax_build_match_tables(
        desc, mask, ratio=opt.match_ratio, min_matches=opt.min_matches,
        chunk=opt.match_chunk,
        verify=(xy, jnp.asarray(intr), k_ver, opt.max_repr_error, opt.verify_hyps))
    scene = jax_make_scene(xy, mask, *tables, jnp.asarray(intr))
    score = np.asarray(jpipe.rank_init_pairs(scene, float(max(W, H))))
    order = np.argsort(-score)
    order = order[score[order] > 0]
    key, k_init = jax.random.split(key)
    row, init = jax_find_best_pair(
        k_init, scene, order, opt.min_initial_inliers, opt.init_max_repr_error,
        opt.init_min_tri_angle, chunk=opt.init_chunk, n_hyp_e=opt.ransac_hyps_e,
        n_hyp_h=opt.ransac_hyps_h)
    assert row is not None, "the reference found no init pair"
    seeded = jpipe.seed_initial_pair(scene, row, init.T, init.points, init.point_ok)
    return dict(xy=np.asarray(xy), desc=np.asarray(desc), mask=np.asarray(mask),
                scene=scene, seeded=seeded, row=row, init=init,
                pair=tuple(int(v) for v in np.asarray(scene.pair_idx)[row]))


@pytest.fixture(scope="module")
def port_chain(frames):
    images, _, intr = frames
    xy, desc, _, mask = extract_features(images, max_keypoints=K, device="cpu")
    scene, stats = tpipe.initialize_sfm(xy, desc, mask, (W, H), intr=intr,
                                        options=tpipe.SfmOptions(**OPTS), device="cpu")
    return dict(xy=xy, desc=desc, mask=mask, scene=scene, stats=stats)


def test_features_agree(jax_chain, port_chain):
    np.testing.assert_array_equal(port_chain["mask"].numpy(), jax_chain["mask"])
    np.testing.assert_allclose(port_chain["xy"].numpy(), jax_chain["xy"], atol=1e-3)
    np.testing.assert_allclose(port_chain["desc"].numpy(), jax_chain["desc"], atol=1e-4)


def test_both_find_an_accurate_init_pair(frames, jax_chain, port_chain):
    _, poses, _ = frames
    st = port_chain["stats"]
    assert st["initialized"] and st["n_good"] > OPTS["min_initial_inliers"]
    assert st["edges"] > 0
    for name, pair, T in (("jax", jax_chain["pair"], np.asarray(jax_chain["init"].T)),
                          ("port", st["init_pair"], st["T_init"].numpy())):
        rot, trans = relative_pose_error_deg(T, poses[pair[0]], poses[pair[1]])
        print(f"{name}: init pair {pair}, rotation error {rot:.4f} deg, "
              f"translation direction error {trans:.4f} deg")
        assert rot < MAX_ROT_DEG and trans < MAX_TRANS_DEG, (name, rot, trans)
    print(f"init pairs agree: {tuple(st['init_pair']) == jax_chain['pair']}")
    seeded = port_chain["scene"]
    assert int(seeded.n_landmarks) == st["n_good"]
    assert int(seeded.pose_valid.sum()) == 2 and int(seeded.pose_fixed.sum()) == 1


def test_rank_and_seed_on_the_reference_scene(jax_chain):
    """Fed the same JAX Scene, the port's rank_init_pairs and
    seed_initial_pair give the reference's output."""
    d = {k: np.asarray(v) for k, v in jax_chain["scene"]._asdict().items()}
    scene = convert.scene_from_numpy(d, "cpu")
    score = tpipe.rank_init_pairs(scene, float(max(W, H)))
    np.testing.assert_allclose(
        score.numpy(), np.asarray(jpipe.rank_init_pairs(jax_chain["scene"], float(max(W, H)))),
        atol=1e-5, rtol=1e-6)
    init = jax_chain["init"]
    seeded = tpipe.seed_initial_pair(scene, jax_chain["row"], torch.as_tensor(np.array(init.T)),
                                     torch.as_tensor(np.array(init.points)),
                                     torch.as_tensor(np.array(init.point_ok)))
    ref = {k: np.asarray(v) for k, v in jax_chain["seeded"]._asdict().items()}
    out = convert.scene_to_numpy(seeded)
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, atol=1e-5, err_msg=k)


def test_scene_from_numpy_resolves_its_device_like_every_entry_point():
    """Without a card the default (the card) raises, as every entry point
    does; ``device="cpu"`` round-trips through ``scene_to_numpy``."""
    from eacham_tpu_torch.sfm.scene import make_scene

    rng = np.random.default_rng(0)
    n, k, p = 3, 5, 2
    scene = make_scene(
        torch.as_tensor(rng.random((n, k, 2)).astype(np.float32)),
        torch.as_tensor(rng.random((n, k)) > 0.3),
        torch.tensor([[0, 1], [1, 2]], dtype=torch.int32), torch.tensor([True, False]),
        torch.as_tensor(rng.integers(0, k, (p, k)).astype(np.int32)),
        torch.as_tensor(rng.random((p, k)) > 0.5),
        torch.as_tensor(rng.integers(0, k, (p, k)).astype(np.int32)),
        torch.as_tensor(rng.random((p, k)) > 0.5),
        torch.tensor([600.0, 600.0, 256.0, 192.0]))
    d = convert.scene_to_numpy(scene)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.scene_from_numpy(d)
    back = convert.scene_from_numpy(d, device="cpu")
    assert all(t.device.type == "cpu" for t in back)
    out = convert.scene_to_numpy(back)
    assert set(out) == set(d)
    for f, v in d.items():
        assert out[f].dtype == v.dtype, f
        np.testing.assert_array_equal(out[f], v, err_msg=f)
