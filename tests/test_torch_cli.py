"""The port's command line on the CPU: images on disk -> ``cli.run`` ->
transform.json, transforms_nerf.json, cloud.ply and trajectory.ply, on
tests/test_cli.py's 10-frame 320x240 fixture.

The port is held to that test's bounds (at least 8 of 10 registered, ATE
< 0.08), its transform.json to the JAX package's writer on the same names,
poses and intrinsics (equal bytes), the NeRF file to inv(pose) @ diag(1,
-1, -1, 1), and the PLY files to their headers' counts. One small
``--frontend deep`` run (6 frames, the shipped weights) checks the deep
path end to end.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from eacham_tpu import cli as jcli
from eacham_tpu.io.saver import positions_json
from eacham_tpu_torch import cli
from eacham_tpu_torch.utils.evaluate import ate_rmse
from eacham_tpu_torch.utils.synthetic import render_sequence

torch.set_num_threads(2)

CONFIG = {
    "images_path": "/images", "transform_path": "/transform.json", "nerfy": True,
    "max_data_count": 0, "ui": False,
    "feature": {"min_features_count": 50, "max_features_count": 512, "inliers_ratio": 0.8},
    "reconstruction": {
        "initial_pair": {"min_inliers": 60, "min_matches": 10, "min_corrs": 10,
                         "max_reprojection_error": 4.0, "min_angle": 1.0},
        "processing": {"min_matches": 10, "min_corrs": 10, "max_reprojection_error": 8.0,
                       "min_angle": 0.8, "min_pnp_inliers": 15},
    },
    "refine_ba": {"method": "LM", "max_iter": 30, "max_toler": 1e-5, "delta": 10.0,
                  "use_preconditioner": False},
    "global_ba": {"method": "LM", "max_iter": 50, "max_toler": 1e-6, "delta": 10.0,
                  "use_preconditioner": False},
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    (root / "images").mkdir()
    rng = np.random.default_rng(3)
    images, poses_gt, intr = render_sequence(rng, n_frames=10, width=320, height=240,
                                             n_blobs=300)
    for i, img in enumerate(images):
        Image.fromarray((img * 255).astype("uint8")).save(root / "images" / f"frame{i:03d}.png")
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps({"root_path": str(root), **CONFIG}))
    return root, cfg_path, poses_gt


@pytest.fixture(scope="module")
def cli_run(dataset):
    root, cfg_path, poses_gt = dataset
    stats = cli.run(str(cfg_path), max_keypoints=512, verbose=False, device="cpu")
    return root, poses_gt, stats


def _centers(poses):
    return -np.einsum("nij,ni->nj", poses[:, :3, :3], poses[:, :3, 3])


def test_cli_registers_most_frames_within_the_ate_bound(cli_run):
    root, poses_gt, stats = cli_run
    assert stats["initialized"] and stats["registered"] >= poses_gt.shape[0] - 2
    assert stats["decoder"] == "native" and stats["loaded"] == 10
    data = json.loads((root / "transform.json").read_text())
    frames = data["frames"]
    assert data["w"] == 320 and data["h"] == 240 and len(frames) == stats["registered"]
    ids = [int(f["file_path"][5:8]) for f in frames]
    est = np.stack([np.asarray(f["transform_matrix"]) for f in frames])
    assert ate_rmse(_centers(est), _centers(poses_gt[ids])) < 0.08


def test_transform_json_is_the_jax_writers(cli_run):
    """The reference's writer on the names, poses and intrinsics that the
    port's file holds gives the same bytes."""
    root, _, _ = cli_run
    data = json.loads((root / "transform.json").read_text())
    names = [f["file_path"] for f in data["frames"]]
    poses = np.stack([np.asarray(f["transform_matrix"]) for f in data["frames"]])
    want = positions_json(names, poses, data["w"], data["h"], data["cx"], data["cy"],
                          data["fl_x"], data["fl_y"])
    assert list(data) == list(want)
    assert (root / "transform.json").read_text() == json.dumps(want, indent=4) + "\n"


def test_cli_nerf_output(cli_run):
    root, _, _ = cli_run
    nerf = json.loads((root / "transforms_nerf.json").read_text())
    src = json.loads((root / "transform.json").read_text())
    assert len(nerf["frames"]) == len(src["frames"])
    for a, b in zip(src["frames"], nerf["frames"]):
        want = np.linalg.inv(np.asarray(a["transform_matrix"])) @ np.diag([1.0, -1.0, -1.0, 1.0])
        np.testing.assert_allclose(np.asarray(b["transform_matrix"]), want, atol=1e-9)


def test_cli_ply_files_hold_their_headers_counts(cli_run):
    root, _, stats = cli_run
    for name, want in (("cloud.ply", None), ("trajectory.ply", stats["registered"])):
        lines = (root / name).read_text().splitlines()
        n = int(lines[2].split()[-1])
        end = lines.index("end_header")
        assert lines[0] == "ply" and len(lines) - end - 1 == n > 0
        assert want is None or n == want


def test_in_frame_mask_is_the_references():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    xy = rng.uniform(-5, 330, (3, 40, 2)).astype(np.float32)
    sizes = np.array([[320, 240], [300, 200], [100, 330]], np.int32)
    want = np.asarray(jcli._in_frame_mask(jnp.asarray(xy), sizes))
    got = cli._in_frame_mask(torch.as_tensor(xy), sizes).numpy()
    assert np.array_equal(got, want)


def test_main_runs_the_cli_and_refuses_what_is_not_ported(dataset, tmp_path):
    root, cfg_path, _ = dataset
    cfg = json.loads(cfg_path.read_text())
    cfg.update(max_data_count=6, transform_path="/six/transform.json", nerfy=False)
    six = tmp_path / "six.json"
    six.write_text(json.dumps(cfg))
    assert cli.main([str(six), "--max-keypoints", "256", "--device", "cpu", "--quiet"]) == 0
    out = json.loads((root / "six" / "transform.json").read_text())
    assert 4 <= len(out["frames"]) <= 6 and not (root / "six" / "transforms_nerf.json").exists()
    # sharding needs a process group of that size, launched by torchrun
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main([str(six), "--devices", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main([str(six), "--distortion", "0.1,0.2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([str(six), "--quiet"])


def test_cli_distortion_on_ingest(dataset, tmp_path):
    """A lens model of nearly zero distortion goes through the undistortion
    hook and leaves the run as it was."""
    root, cfg_path, _ = dataset
    cfg = json.loads(cfg_path.read_text())
    cfg.update(max_data_count=6, transform_path="/dist/transform.json", nerfy=False)
    path = tmp_path / "dist.json"
    path.write_text(json.dumps(cfg))
    stats = cli.run(str(path), max_keypoints=256, verbose=False, device="cpu",
                    distortion=[1e-4, 0.0, 0.0, 0.0, 0.0])
    assert stats["initialized"] and stats["registered"] >= 4


def test_cli_deep_frontend(dataset, tmp_path):
    """``--frontend deep`` on 6 frames with the shipped weights: SuperPoint
    features, LightGlue tables over all 15 pairs with epipolar
    verification, then the same reconstruction and outputs."""
    root, cfg_path, poses_gt = dataset
    cfg = json.loads(cfg_path.read_text())
    cfg.update(max_data_count=6, transform_path="/deep/transform.json")
    path = tmp_path / "deep.json"
    path.write_text(json.dumps(cfg))
    stats = cli.run(str(path), max_keypoints=256, frontend="deep", verbose=False,
                    device="cpu", match_threshold=0.3)
    assert stats["initialized"] and stats["pairs"] >= 15 and stats["edges"] > 0
    data = json.loads((root / "deep" / "transform.json").read_text())
    assert len(data["frames"]) == stats["registered"] >= 4
    assert (root / "deep" / "transforms_nerf.json").exists()
    ids = [int(f["file_path"][5:8]) for f in data["frames"]]
    est = np.stack([np.asarray(f["transform_matrix"]) for f in data["frames"]])
    assert ate_rmse(_centers(est), _centers(poses_gt[ids])) < 0.08
