"""The port's stereo / depth / Hamming tools (geometry/stereo.py) and the
TUM and KITTI readers (io/datasets.py) against the JAX package on the same
inputs: the counterparts of tests/test_datasets_stereo.py and of the
format halves of tests/test_dataset_fixtures.py, on the CPU.

Tolerances: backprojection agrees with the reference to 1e-5 relative (the
same fp32 formula); Hamming distances, matches and every reader's arrays
are exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from eacham_tpu.geometry import stereo as jst
from eacham_tpu.io import datasets as jds
from eacham_tpu_torch.geometry import stereo as tst
from eacham_tpu_torch.io import datasets as tds

DATA = Path(__file__).parent / "data"


def test_stereo_backprojection(rng):
    f, b = 500.0, 0.25
    intr = np.asarray([f, f, 320.0, 240.0], np.float32)
    pts = rng.uniform(-1, 1, (50, 3)) + [0, 0, 6.0]
    uL = f * pts[:, 0] / pts[:, 2] + 320
    vL = f * pts[:, 1] / pts[:, 2] + 240
    uR = f * (pts[:, 0] - b) / pts[:, 2] + 320
    uv = np.stack([uL, vL], -1).astype(np.float32)
    got = tst.point_from_stereo(torch.as_tensor(uv), torch.as_tensor(uR, dtype=torch.float32),
                                torch.as_tensor(intr), b).numpy()
    want = np.asarray(jst.point_from_stereo(jnp.asarray(uv), jnp.asarray(uR, jnp.float32),
                                            jnp.asarray(intr), b))
    np.testing.assert_allclose(got, pts, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_depth_backprojection(rng):
    intr = np.asarray([100.0, 100.0, 32.0, 24.0], np.float32)
    depth = rng.uniform(1, 5, (48, 64)).astype(np.float32)
    depth[10, 20] = 0.0
    uv = np.asarray([[20.0, 10.0], [30.0, 15.0], [70.5, -3.0]], np.float32)   # last: clamped
    pts, valid = tst.point_from_depth(torch.as_tensor(uv), torch.as_tensor(depth),
                                      torch.as_tensor(intr))
    pts_r, valid_r = jst.point_from_depth(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(intr))
    assert valid.tolist() == [False, True, True] == np.asarray(valid_r).tolist()
    z = float(depth[15, 30])
    np.testing.assert_allclose(pts[1].numpy(), [(30 - 32) / 100 * z, (15 - 24) / 100 * z, z],
                               rtol=1e-5)
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_r), rtol=1e-5)


def test_hamming(rng):
    d1 = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    d2 = d1.copy()
    d2[0, 0] ^= 0b1011  # 3 bit flips
    dist = tst.hamming_distance(torch.as_tensor(d1), torch.as_tensor(d2))
    assert dist.dtype == torch.int32
    np.testing.assert_array_equal(
        dist.numpy(), np.asarray(jst.hamming_distance(jnp.asarray(d1), jnp.asarray(d2))))
    assert dist[0, 0] == 3 and all(dist[i, i] == 0 for i in range(1, 8))
    idx, ok = tst.match_hamming(torch.as_tensor(d1), torch.as_tensor(d2),
                                torch.ones(8, dtype=torch.bool), torch.ones(8, dtype=torch.bool))
    assert np.array_equal(idx.numpy()[ok.numpy()], np.arange(8)[ok.numpy()])
    assert int(ok.sum()) >= 6


def test_match_hamming_ties_go_to_the_first_minimum(rng):
    """Duplicated rows tie exactly: both packages pick the first, and a
    masked-out row never wins; results equal the reference's bit for bit."""
    d2 = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    d2[5] = d2[3]
    d2[20] = d2[11]
    d1 = d2[[3, 5, 11, 20, 30, 0]].copy()
    d1[4, 0] ^= 0b1
    m1 = np.ones(6, bool)
    m2 = np.ones(40, bool)
    m2[30] = False
    got = tst.match_hamming(torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(m1),
                            torch.as_tensor(m2), max_distance=96, ratio=1.1)
    want = jst.match_hamming(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1),
                             jnp.asarray(m2), max_distance=96, ratio=1.1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0][:4].tolist() == [3, 3, 11, 11]


@pytest.fixture
def tum_dir(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "rgb").mkdir()
    lines = ["# color images", "# ts filename"]
    for i in range(4):
        name = f"rgb/{1000.0 + 0.1 * i:.4f}.png"
        arr = (rng.random((24, 32, 3)) * 255).astype("uint8")
        Image.fromarray(arr).save(tmp_path / name)
        lines.append(f"{1000.0 + 0.1 * i:.4f} {name}")
    (tmp_path / "rgb.txt").write_text("\n".join(lines))
    gt = ["# gt"]
    for i in range(40):
        gt.append(f"{999.95 + 0.01 * i:.4f} {0.01 * i:.3f} 0 0 0 0 0 1")
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt))
    return tmp_path


def _same_batch(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.sizes, b.sizes)
    assert a.names == b.names


def test_tum_reader(tum_dir):
    ds = tds.TumDataset.open(tum_dir)
    ref = jds.TumDataset.open(tum_dir)
    assert ds.files == ref.files and len(ds.files) == 4
    np.testing.assert_array_equal(ds.timestamps, ref.timestamps)
    batch = ds.load()
    assert batch.images.shape == (4, 24, 32)
    _same_batch(batch, ref.load())
    poses, valid = ds.gt_for_frames()
    poses_r, valid_r = ref.gt_for_frames()
    assert poses.shape == (4, 4, 4) and valid.all()
    np.testing.assert_array_equal(poses, poses_r)
    np.testing.assert_array_equal(valid, valid_r)
    np.testing.assert_allclose(poses[1, 0, 3], 0.15, atol=0.011)


@pytest.fixture
def kitti_dir(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "image_0").mkdir()
    for i in range(3):
        arr = (rng.random((20, 40)) * 255).astype("uint8")
        Image.fromarray(arr, "L").save(tmp_path / "image_0" / f"{i:06d}.png")
    (tmp_path / "calib.txt").write_text(
        "P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0\n")
    poses = []
    for i in range(3):
        P = np.eye(4)[:3]
        P[0, 3] = 1.5 * i
        poses.append(" ".join(str(v) for v in P.reshape(-1)))
    (tmp_path / "poses.txt").write_text("\n".join(poses))
    return tmp_path


def test_kitti_reader(kitti_dir):
    ds = tds.KittiDataset.open(kitti_dir, poses_file=kitti_dir / "poses.txt")
    ref = jds.KittiDataset.open(kitti_dir, poses_file=kitti_dir / "poses.txt")
    assert ds.files == ref.files and len(ds.files) == 3
    np.testing.assert_array_equal(ds.intr, ref.intr)
    np.testing.assert_allclose(ds.intr, [700, 700, 600, 180])
    np.testing.assert_array_equal(ds.groundtruth_poses, ref.groundtruth_poses)
    assert ds.groundtruth_poses[2, 0, 3] == 3.0
    batch = ds.load(max_count=2)
    assert batch.images.shape[0] == 2
    _same_batch(batch, ref.load(max_count=2))


def test_tum_gt_quaternion(tmp_path):
    path = tmp_path / "gt.txt"
    # 90 deg about z: q = (0, 0, sin45, cos45)
    path.write_text("1.0 1 2 3 0 0 0.7071068 0.7071068\n")
    gt = tds.load_tum_groundtruth(path)
    np.testing.assert_array_equal(gt.poses, jds.load_tum_groundtruth(path).poses)
    R = gt.poses[0, :3, :3]
    np.testing.assert_allclose(R @ [1, 0, 0], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(gt.poses[0, :3, 3], [1, 2, 3])


def test_tum_fixture_parses_real_format():
    ds = tds.TumDataset.open(DATA / "tum_mini")
    ref = jds.TumDataset.open(DATA / "tum_mini")
    assert len(ds.files) == 12 and ds.files == ref.files
    assert ds.files[0].startswith("rgb/") and ds.files[0].endswith(".png")
    assert ds.timestamps[0] > 1e9 and (np.diff(ds.timestamps) > 0).all()
    np.testing.assert_array_equal(ds.timestamps, ref.timestamps)
    gt_poses, ok = ds.gt_for_frames()
    assert ok.all()
    np.testing.assert_array_equal(gt_poses, ref.gt_for_frames()[0])
    batch = ds.load()
    assert batch.images.shape == (12, 192, 256) and batch.images.max() > 0.2
    _same_batch(batch, ref.load())
    depth, has = ds.load_depth()                 # the fixture has no depth.txt
    assert depth is None and not has.any() and has.shape == (12,)


def test_kitti_fixture_parses_real_format():
    root = DATA / "kitti_mini" / "sequences" / "00"
    poses = DATA / "kitti_mini" / "poses" / "00.txt"
    ds = tds.KittiDataset.open(root, poses_file=poses)
    ref = jds.KittiDataset.open(root, poses_file=poses)
    assert len(ds.files) == 12 and ds.files[0] == "000000.png" and ds.files == ref.files
    np.testing.assert_allclose(ds.intr, [307.2000122, 307.2000122, 128.0, 96.0], rtol=1e-6)
    np.testing.assert_array_equal(ds.intr, ref.intr)
    assert ds.groundtruth_poses.shape == (12, 4, 4)
    np.testing.assert_array_equal(ds.groundtruth_poses, ref.groundtruth_poses)
    batch = ds.load()
    assert batch.images.shape == (12, 192, 256)
    _same_batch(batch, ref.load())
