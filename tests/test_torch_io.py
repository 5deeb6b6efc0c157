"""The port's ``io/`` against the JAX package's on the same inputs, on the
CPU: config parsing and its options, the transform.json and NeRF writers,
PLY export, image loading (native and PIL decoders), frame streams, the
lens model, and scene checkpoints in both directions, with ``resume_sfm``
continuing from a checkpoint of either package.

Everything here but the resume is exact: equal fields, equal bytes, equal
arrays. The lens model is held to 1e-4 px. The resume is held to outcomes
(the two packages cannot share RANSAC draws): tests/test_export_checkpoint.py's
case, 7 cameras, the last three de-registered, must come back to 7.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from eacham_tpu.geometry import camera as jcam
from eacham_tpu.io import checkpoint as jckpt
from eacham_tpu.io import config as jconfig
from eacham_tpu.io import export as jexport
from eacham_tpu.io import images as jimages
from eacham_tpu.io import nerf as jnerf
from eacham_tpu.io import saver as jsaver
from eacham_tpu.io import stream as jstream
from eacham_tpu.sfm.matches import all_pairs_index
from eacham_tpu.sfm.scene import Scene as JaxScene, alloc_landmarks, make_scene
from eacham_tpu_torch.convert import scene_from_numpy, scene_to_numpy
from eacham_tpu_torch.geometry import camera as tcam
from eacham_tpu_torch.io import checkpoint as tckpt
from eacham_tpu_torch.io import config as tconfig
from eacham_tpu_torch.io import export as texport
from eacham_tpu_torch.io import images as timages
from eacham_tpu_torch.io import nerf as tnerf
from eacham_tpu_torch.io import saver as tsaver
from eacham_tpu_torch.io import stream as tstream
from eacham_tpu_torch.sfm.pipeline import SfmOptions, resume_sfm, run_sfm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.json"))


# ---- config -------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_parse_config_gives_the_references_fields(path):
    want = dataclasses.asdict(jconfig.load_config(path))
    got = dataclasses.asdict(tconfig.load_config(path))
    assert got == want


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
@pytest.mark.parametrize("preconditioned", [False, True])
def test_to_options_gives_the_references_options(path, preconditioned):
    data = json.loads(path.read_text())
    for section in ("refine_ba", "global_ba"):
        data[section]["use_preconditioner"] = preconditioned
    want = dataclasses.asdict(jconfig.parse_config(data).to_options(max_keypoints=512))
    got = dataclasses.asdict(tconfig.parse_config(data).to_options(max_keypoints=512))
    assert set(got) == set(want)
    assert got == want
    assert got["refine_solver"] == ("pcg" if preconditioned else "auto")


# ---- writers ------------------------------------------------------------------

def _poses(rng, n):
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(n, 3))
    a = rng.uniform(-0.3, 0.3, n)
    poses[:, 0, 0], poses[:, 0, 2] = np.cos(a), -np.sin(a)
    poses[:, 2, 0], poses[:, 2, 2] = np.sin(a), np.cos(a)
    return poses.astype(np.float32)


def test_positions_json_and_the_nerf_converter_are_the_references(tmp_path):
    rng = np.random.default_rng(0)
    poses = _poses(rng, 5)
    names = [f"frame{i:03d}.png" for i in range(5)]
    args = (640, 480, 320.5, 240.25, 612.3, 610.9)
    assert tsaver.positions_json(names, poses, *args) == jsaver.positions_json(names, poses, *args)
    for pkg, d in ((tsaver, "port"), (jsaver, "jax")):
        (tmp_path / d).mkdir()
        pkg.save_positions(tmp_path / d / "transform.json", names, poses, *args)
    assert (tmp_path / "port" / "transform.json").read_bytes() == \
        (tmp_path / "jax" / "transform.json").read_bytes()
    out_t = tnerf.transform_to_nerf(tmp_path / "port")
    out_j = jnerf.transform_to_nerf(tmp_path / "jax")
    assert out_t.read_bytes() == out_j.read_bytes()
    np.testing.assert_array_equal(tnerf.convert_pose(poses[1].astype(np.float64)),
                                  jnerf.convert_pose(poses[1].astype(np.float64)))
    assert tnerf.main([str(tmp_path / "port")]) == 0
    assert tnerf.main([str(tmp_path)]) == -1


def _jax_scene(rng):
    """A small reference scene (4 frames, 16 keypoints, landmarks on frames
    0-2, frame 3 unregistered)."""
    N, K = 4, 16
    pair_idx = jnp.asarray(all_pairs_index(N))
    P = pair_idx.shape[0]
    scene = make_scene(
        keypoints=jnp.asarray(rng.uniform(0, 100, (N, K, 2)).astype(np.float32)),
        kp_mask=jnp.ones((N, K), bool), pair_idx=pair_idx,
        pair_ok=jnp.ones((P,), bool), match_ij=jnp.zeros((P, K), jnp.int32),
        valid_ij=jnp.zeros((P, K), bool), match_ji=jnp.zeros((P, K), jnp.int32),
        valid_ji=jnp.zeros((P, K), bool), intr=jnp.asarray([100.0, 100.0, 50.0, 50.0]),
        lm_capacity=32)
    pts = jnp.asarray(rng.normal(size=(K, 3)).astype(np.float32) + [0, 0, 5])
    scene, ids = alloc_landmarks(scene, pts, jnp.ones((K,), bool))
    ids3 = np.asarray(ids).copy()
    ids3[::3] = -1                    # landmarks seen by frames 0, 1 and (some) 2
    pose = np.asarray(scene.pose).copy()
    pose[1:3] = _poses(rng, 2)
    return scene._replace(
        pose=jnp.asarray(pose),
        pose_valid=scene.pose_valid.at[:3].set(True),
        kp2lm=scene.kp2lm.at[0].set(ids).at[1].set(ids).at[2].set(jnp.asarray(ids3)))


@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_ply_export_and_landmark_colors_are_the_references(tmp_path, color):
    rng = np.random.default_rng(1)
    jscene = _jax_scene(rng)
    tscene = scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()},
                              device="cpu")
    shape = (4, 120, 110) + ((3,) if color == "rgb" else ())
    images = rng.random(shape).astype(np.float32)
    want = jexport.landmark_colors(jscene, images)
    got = texport.landmark_colors(tscene, images)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for min_obs in (2, 3):
        n_t = texport.export_cloud(tmp_path / "t.ply", tscene, min_obs, color=got)
        n_j = jexport.export_cloud(tmp_path / "j.ply", jscene, min_obs, color=want)
        assert n_t == n_j and (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert texport.export_trajectory(tmp_path / "tt.ply", tscene) == \
        jexport.export_trajectory(tmp_path / "jt.ply", jscene) == 3
    assert (tmp_path / "tt.ply").read_bytes() == (tmp_path / "jt.ply").read_bytes()


# ---- images and streams -------------------------------------------------------

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Frames of three sizes in PNG (gray and RGB), binary PGM and PPM, and
    JPEG; a text file that is not an image."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(2)
    for i, (ext, mode, (w, h)) in enumerate([
            (".png", "L", (64, 48)), (".png", "RGB", (80, 40)), (".pgm", "L", (64, 48)),
            (".ppm", "RGB", (50, 60)), (".jpg", "RGB", (64, 48)), (".PNG", "L", (30, 20))]):
        shape = (h, w) + ((3,) if mode == "RGB" else ())
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(d / f"f{i}{ext}")
    (d / "notes.txt").write_text("not an image")
    return d


@pytest.mark.parametrize("backend", ["auto", "pil", "native"])
def test_load_image_dir_is_the_references(image_dir, backend, tmp_path):
    if backend == "native":
        # the native decoder takes no JPEG: strict mode refuses the directory,
        # in both packages, and decodes one without JPEG
        for pkg in (timages, jimages):
            with pytest.raises(RuntimeError, match="cannot decode"):
                pkg.load_image_dir(image_dir, backend="native")
        for f in image_dir.iterdir():
            if f.suffix != ".jpg":
                (tmp_path / f.name).write_bytes(f.read_bytes())
        image_dir = tmp_path
    want = jimages.load_image_dir(image_dir, backend=backend)
    got = timages.load_image_dir(image_dir, backend=backend)
    assert got.names == want.names and len(got.names) >= 5
    np.testing.assert_array_equal(got.sizes, want.sizes)
    assert got.images.dtype == want.images.dtype == np.float32
    np.testing.assert_array_equal(got.images, want.images)
    assert got.backend == {"auto": "native+pil", "pil": "pil", "native": "native"}[backend]
    cut = timages.load_image_dir(image_dir, max_count=2, backend=backend)
    assert cut.names == want.names[:2]


def test_load_image_dir_with_color_and_an_empty_directory(image_dir, tmp_path):
    want = jimages.load_image_dir(image_dir, keep_color=True)
    got = timages.load_image_dir(image_dir, keep_color=True)
    np.testing.assert_array_equal(got.color_images, want.color_images)
    np.testing.assert_array_equal(got.images, want.images)
    with pytest.raises(FileNotFoundError):
        timages.load_image_dir(tmp_path)
    with pytest.raises(ValueError, match="backend"):
        timages.load_image_dir(image_dir, backend="opencv")


def test_downsize_policy_and_listing_are_the_references(image_dir):
    for rows in (1, 800, 1500, 1501, 1580, 3000, 12000):
        assert timages.downsize_policy(rows) == jimages.downsize_policy(rows)
    assert timages.list_images(image_dir) == jimages.list_images(image_dir)


def test_a_tall_frame_is_downsized_as_the_reference_does(tmp_path):
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (1580, 40), dtype=np.uint8), "L").save(tmp_path / "t.png")
    for backend in ("native", "pil"):
        want = jimages.load_image_dir(tmp_path, backend=backend)
        got = timages.load_image_dir(tmp_path, backend=backend)
        np.testing.assert_array_equal(got.sizes, want.sizes)
        np.testing.assert_array_equal(got.images, want.images)
        assert got.height < 1580


def test_replay_source_and_drain_are_the_references(image_dir):
    src_t, src_j = tstream.ReplaySource(image_dir), jstream.ReplaySource(image_dir)
    for (it, gt, nt), (ij, gj, nj) in zip(tstream.frames(src_t), jstream.frames(src_j)):
        assert (it, nt) == (ij, nj)
        np.testing.assert_array_equal(gt, gj)
    for max_frames in (0, 3):
        got = tstream.drain(tstream.ReplaySource(image_dir), max_frames=max_frames)
        want = jstream.drain(jstream.ReplaySource(image_dir), max_frames=max_frames)
        assert got.names == want.names
        np.testing.assert_array_equal(got.sizes, want.sizes)
        np.testing.assert_array_equal(got.images, want.images)
    empty = tstream.ReplaySource(image_dir)
    empty.files = []
    with pytest.raises(RuntimeError, match="no frames"):
        tstream.drain(empty)


# ---- lens model ---------------------------------------------------------------

def test_undistort_keypoints_agrees_with_the_reference():
    """A Brown-Conrady lens (barrel, with tangential terms) at 640x480:
    distorted pixels in, pinhole pixels out, within 1e-4 px of the
    reference and within 1e-3 px of the pixels that were distorted."""
    rng = np.random.default_rng(4)
    intr = np.array([500.0, 505.0, 320.0, 240.0], np.float32)
    dist = np.array([-0.28, 0.09, 1e-3, -5e-4, -0.01], np.float32)
    uv = rng.uniform([0, 0], [640, 480], (3, 200, 2)).astype(np.float32)
    xy = (uv - intr[2:]) / intr[:2]
    xy_d = np.asarray(jcam.distort_normalized(jnp.asarray(xy), jnp.asarray(dist)))
    np.testing.assert_allclose(
        tcam.distort_normalized(torch.as_tensor(xy), torch.as_tensor(dist)).numpy(),
        xy_d, atol=1e-6)
    uv_d = (xy_d * intr[:2] + intr[2:]).astype(np.float32)
    want = np.asarray(jcam.undistort_keypoints(jnp.asarray(uv_d), jnp.asarray(intr),
                                               jnp.asarray(dist)))
    got = tcam.undistort_keypoints(torch.as_tensor(uv_d), torch.as_tensor(intr),
                                   torch.as_tensor(dist)).numpy()
    assert np.abs(got - want).max() < 1e-4
    inner = np.linalg.norm(xy, axis=-1) < 0.5
    assert np.abs(got - uv)[inner].max() < 1e-3
    zero = tcam.undistort_keypoints(torch.as_tensor(uv), torch.as_tensor(intr),
                                    torch.zeros(5))
    np.testing.assert_allclose(zero.numpy(), uv, atol=1e-4)


# ---- checkpoints --------------------------------------------------------------

def _assert_same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_jax_checkpoint_loads_in_the_port(tmp_path):
    jscene = _jax_scene(np.random.default_rng(5))
    path = tmp_path / "jax.npz"
    jckpt.save_scene(path, jscene, excluded=np.zeros(4, bool), names=np.asarray(["a", "b"]))
    scene, extra = tckpt.load_scene(path, device="cpu")
    _assert_same_arrays(scene_to_numpy(scene),
                        {k: np.asarray(v) for k, v in jscene._asdict().items()})
    assert set(extra) == {"excluded", "names"} and list(extra["names"]) == ["a", "b"]


def test_a_port_checkpoint_loads_in_jax(tmp_path):
    jscene = _jax_scene(np.random.default_rng(6))
    want = {k: np.asarray(v) for k, v in jscene._asdict().items()}
    scene = scene_from_numpy(want, device="cpu")
    # an index field that came out int64 is written as the reference's int32
    scene = scene._replace(pair_idx=scene.pair_idx.long())
    path = tmp_path / "port.npz"
    tckpt.save_scene(path, scene, desc=torch.ones(2, 3), n_frames=np.int32(4))
    assert not list(tmp_path.glob("*.tmp.npz"))
    loaded, extra = jckpt.load_scene(path)
    _assert_same_arrays({k: np.asarray(v) for k, v in loaded._asdict().items()}, want)
    np.testing.assert_array_equal(extra["desc"], np.ones((2, 3), np.float32))
    assert int(extra["n_frames"]) == 4


# ---- resume_sfm ---------------------------------------------------------------

RESUME_OPTS = dict(min_initial_inliers=60, min_matches=20, ransac_hyps_e=128,
                   ransac_hyps_h=64, ransac_hyps_pnp=128, lm_capacity=2048,
                   refine_max_iters=10, global_max_iters=15)


@pytest.fixture(scope="module")
def partial_scene():
    """tests/test_export_checkpoint.py's resume case: 7 cameras reconstructed,
    then frames 4-6 de-registered (their landmark links cut)."""
    from tests.test_pipeline import make_feature_world

    rng = np.random.default_rng(31)
    poses_gt, _, intr, kps, desc, mask = make_feature_world(rng, n_cams=7, n_pts=200,
                                                            noise=0.3)
    scene, stats = run_sfm(kps, desc, mask, image_size=(640, 480),
                           intr=intr.astype(np.float32), options=SfmOptions(**RESUME_OPTS),
                           device="cpu")
    assert stats["registered"] == 7
    drop = torch.zeros(7, dtype=torch.bool)
    drop[4:] = True
    drop &= scene.pose_valid
    return scene._replace(pose_valid=scene.pose_valid & ~drop,
                          kp2lm=torch.where(drop[:, None], -1, scene.kp2lm))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_from_a_checkpoint(partial_scene, tmp_path, writer):
    path = tmp_path / "partial.npz"
    if writer == "port":
        tckpt.save_scene(path, partial_scene)
    else:
        jckpt.save_scene(path, JaxScene(**{k: jnp.asarray(v) for k, v in
                                           scene_to_numpy(partial_scene).items()}))
    loaded, _ = tckpt.load_scene(path, device="cpu")
    assert int(loaded.pose_valid.sum()) == 4
    resumed, stats = resume_sfm(loaded, options=SfmOptions(**RESUME_OPTS), verbose=False,
                                device="cpu")
    assert stats["registered"] == 7 and int(resumed.pose_valid.sum()) == 7
    assert stats["initialized"] and stats["init_pair"] == (-1, -1)
    assert stats["global_ba"] is not None and stats["checkpoints"] == 0


def test_resume_writes_checkpoints_and_has_a_sweep_only_path(partial_scene, tmp_path):
    """``checkpoint_path`` with ``sweep_segment=1``: a checkpoint after each
    segment that ended with candidates left (three here: the third ended on
    the last frame); the last one loads in the JAX package with the sweep's
    registered frames, and a resume from it keeps them."""
    path = tmp_path / "ck.npz"
    opt = SfmOptions(**RESUME_OPTS, sweep_segment=1, checkpoint_path=str(path))
    scene, stats = resume_sfm(partial_scene, options=opt, verbose=False, finalize=False,
                              device="cpu")
    assert (stats["registered"], stats["initialized"], stats["finalized"]) == (7, True, False)
    assert stats["checkpoints"] == 3 and set(stats["seconds"]) == {"sweep"}
    ck, _ = jckpt.load_scene(path)
    assert np.array_equal(np.asarray(ck.pose_valid), scene.pose_valid.numpy())
    loaded, _ = tckpt.load_scene(path, device="cpu")
    again, st2 = resume_sfm(loaded, options=SfmOptions(**RESUME_OPTS), verbose=False,
                            device="cpu")
    assert torch.equal(again.pose_valid, scene.pose_valid) and st2["registered"] == 7


def test_resume_without_an_initialized_pair():
    scene = run_sfm(np.zeros((2, 8, 2), np.float32), np.zeros((2, 8, 256), np.float32),
                    np.zeros((2, 8), bool), (64, 64), options=SfmOptions(min_matches=1),
                    device="cpu")[0]
    _, stats = resume_sfm(scene, verbose=False, device="cpu")
    assert stats == {"registered": 0, "landmarks": 0, "initialized": False}
