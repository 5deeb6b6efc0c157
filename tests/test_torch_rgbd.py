"""The port's metric RGB-D / stereo reconstruction (sfm/rgbd.py) against the
JAX package on the same worlds, made from a seed with numpy, on the CPU:
the counterparts of tests/test_rgbd.py, plus direct checks of the landmark
adoption and the depth seeding on a hand-built scene.

The two packages draw their PnP hypotheses from different random streams,
so the pipeline runs are held to outcomes: equal registered counts, and
each package's absolute camera-centre error (no alignment of any kind:
frame 0 is the gauge, the depth channel the scale) to the reference's own
bounds, 0.05 with exact depth or stereo and 0.15 with 1% depth noise. The
adoption and seeding steps are deterministic: ``kp2lm`` must be equal
exactly, seeded points within 1e-5 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eacham_tpu.sfm import rgbd as jrgbd
from eacham_tpu.sfm.scene import Scene as JaxScene
from eacham_tpu.sfm.scene import frame_pair_table as jax_frame_pair_table
from eacham_tpu_torch import convert
from eacham_tpu_torch.sfm import rgbd as trgbd
from eacham_tpu_torch.sfm.pipeline import SfmOptions
from eacham_tpu_torch.sfm.scene import frame_pair_table
from tests.test_rgbd import OPTS as JAX_OPTS, _abs_center_rmse, _metric_world

torch.set_num_threads(2)

OPTS = SfmOptions(**{f.name: getattr(JAX_OPTS, f.name) for f in dataclasses.fields(JAX_OPTS)})


def _np(x):
    return np.asarray(x)


def _both(uv, desc, vis, kp_z, intr):
    """The same inputs through both packages: ((scene, stats) of the
    reference, (scene, stats) of the port)."""
    js, jst = jrgbd.run_sfm_rgbd(uv, desc, vis, jnp.asarray(kp_z), intr, options=JAX_OPTS,
                                 verbose=False)
    ts, tst = trgbd.run_sfm_rgbd(_np(uv), _np(desc), _np(vis), _np(kp_z), _np(intr),
                                 options=OPTS, verbose=False, device="cpu")
    return (js, jst), (ts, tst)


def _check_pipeline(world, kp_z, bound):
    uv, desc, vis, pc, Ts, intr = world
    (js, jst), (ts, tst) = _both(uv, desc, vis, kp_z, intr)
    assert tst["initialized"] and set(tst) >= {"registered", "landmarks", "initialized"}
    assert tst["registered"] == jst["registered"] >= 7, (tst, jst)
    r_jax = _abs_center_rmse(js, Ts)
    r_port = _abs_center_rmse(ts, Ts)        # (CPU tensors read as arrays)
    assert r_jax < bound and r_port < bound, (r_jax, r_port)
    assert tst["landmarks"] > 100 and tst["global_ba"] is not None


def test_rgbd_metric_scale(rng):
    world = _metric_world(rng)
    pc, vis = world[3], _np(world[2])
    _check_pipeline(world, (pc[..., 2] * vis).astype(np.float32), 0.05)


def test_rgbd_noisy_depth(rng):
    world = _metric_world(rng)
    pc, vis = world[3], _np(world[2])
    z = pc[..., 2] * (1.0 + rng.normal(scale=0.01, size=pc.shape[:2]))
    _check_pipeline(world, (z * vis).astype(np.float32), 0.15)


def test_stereo_depth_roundtrip(rng):
    """stereo_depth_at_keypoints inverts a rendered rectified disparity, as
    the reference's does (1e-5 relative between the packages)."""
    uv, desc, vis, pc, Ts, intr = _metric_world(rng)
    baseline, f, z = 0.2, float(intr[0]), pc[..., 2]
    u_right = (_np(uv[..., 0]) - f * baseline / z).astype(np.float32)
    kp_z = trgbd.stereo_depth_at_keypoints(_np(uv), u_right, _np(intr), baseline,
                                           device="cpu").numpy()
    want = _np(jrgbd.stereo_depth_at_keypoints(uv, jnp.asarray(u_right), intr, baseline))
    v = _np(vis)
    np.testing.assert_allclose(kp_z[v], z[v], rtol=1e-4)
    np.testing.assert_allclose(kp_z, want, rtol=1e-5)
    # no disparity (or a negative one) is no depth
    flat = trgbd.stereo_depth_at_keypoints(np.array([[5.0, 1.0], [5.0, 1.0]], np.float32),
                                           np.array([5.05, 7.0], np.float32), _np(intr),
                                           baseline, device="cpu")
    assert flat.tolist() == [0.0, 0.0]


def test_stereo_metric_pipeline(rng):
    world = _metric_world(rng)
    uv, desc, vis, pc, Ts, intr = world
    baseline, f = 0.2, float(intr[0])
    u_right = (_np(uv[..., 0]) - f * baseline / pc[..., 2]).astype(np.float32)
    kp_z = trgbd.stereo_depth_at_keypoints(_np(uv), u_right, _np(intr), baseline,
                                           device="cpu").numpy() * _np(vis)
    _check_pipeline(world, kp_z.astype(np.float32), 0.05)


def test_depth_at_keypoints():
    depth = np.arange(12.0, dtype=np.float32).reshape(1, 3, 4)
    xy = np.asarray([[[1.2, 0.4], [3.9, 2.1], [-2.0, 9.0]]], np.float32)
    z = trgbd.depth_at_keypoints(depth, xy, device="cpu")
    np.testing.assert_array_equal(z.numpy(), [[1.0, 11.0, 8.0]])
    np.testing.assert_array_equal(
        z.numpy(), _np(jrgbd.depth_at_keypoints(jnp.asarray(depth), jnp.asarray(xy))))


def test_tum_depth_loading(tmp_path):
    """TumDataset.load_depth: 16-bit PNG / 5000, nearest stamp within
    max_dt, zeros where a frame has none; equal to the reference's arrays."""
    from PIL import Image

    from eacham_tpu.io.datasets import TumDataset as JaxTum
    from eacham_tpu_torch.io.datasets import TumDataset

    root = tmp_path
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb_lines, depth_lines = ["# c"], ["# d"]
    for i, t in enumerate([1.00, 1.05, 1.10]):
        img = Image.fromarray((np.ones((8, 10)) * 80).astype(np.uint8))
        img.save(root / "rgb" / f"{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i != 1:  # frame 1 has NO depth -> must come back invalid
            d = (np.full((8, 10), 5000 * (i + 1))).astype(np.uint16)
            d[2, 3] = 1234
            Image.fromarray(d, mode="I;16").save(root / "depth" / f"{t + 0.004:.6f}.png")
            depth_lines.append(f"{t + 0.004:.6f} depth/{t + 0.004:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(depth_lines))

    depth, has = TumDataset.open(root).load_depth()
    depth_r, has_r = JaxTum.open(root).load_depth()
    assert has.tolist() == [True, False, True] == has_r.tolist()
    assert depth.dtype == np.float32
    np.testing.assert_array_equal(depth, depth_r)
    np.testing.assert_allclose(depth[0, 0, 0], 1.0)
    np.testing.assert_allclose(depth[1], 0.0)
    np.testing.assert_allclose(depth[2, 5, 5], 3.0)
    np.testing.assert_allclose(depth[0, 2, 3], 1234 / 5000.0)


@pytest.fixture(scope="module")
def hand_scene():
    """A finished reference scene, then made hard for the adoption rule:
    every frame's keypoints linked to random landmarks (a third unlinked),
    a fifth of the landmarks invalid and two frames unregistered, so that a
    keypoint's observers offer different landmarks and the first one must
    win."""
    rng = np.random.default_rng(3)
    uv, desc, vis, pc, Ts, intr = _metric_world(rng)
    kp_z = jnp.asarray((pc[..., 2] * _np(vis)).astype(np.float32))
    js, _ = jrgbd.run_sfm_rgbd(uv, desc, vis, kp_z, intr, options=JAX_OPTS, verbose=False)
    d = {f: np.array(getattr(js, f)) for f in js._fields}
    N, K = d["kp2lm"].shape
    L = d["points"].shape[0]
    kp2lm = rng.integers(0, int(d["n_landmarks"]), size=(N, K)).astype(np.int32)
    kp2lm[rng.random((N, K)) < 0.33] = -1
    d["kp2lm"] = kp2lm
    d["lm_valid"] = d["lm_valid"] & (rng.random(L) > 0.2)
    d["pose_valid"][[2, 6]] = False
    return d, kp_z


@pytest.mark.parametrize("cur", [3, 5, 7])
def test_adopt_links_and_seed_frame_equal_the_reference(hand_scene, cur):
    d, kp_z = hand_scene
    N = d["kp2lm"].shape[0]
    jscene = JaxScene(**{f: jnp.asarray(v) for f, v in d.items()})
    tscene = convert.scene_from_numpy(d, device="cpu")
    fp_j = jax_frame_pair_table(d["pair_idx"], N)
    fp_t = frame_pair_table(d["pair_idx"], N)
    np.testing.assert_array_equal(fp_t, fp_j)

    ja, jn = jrgbd._adopt_links(jscene, jnp.int32(cur), jnp.asarray(fp_j[cur]))
    ta, tn = trgbd._adopt_links(tscene, cur, torch.as_tensor(fp_t[cur]))
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(ta.kp2lm.numpy(), _np(ja.kp2lm))

    z = _np(kp_z[cur]).copy()
    z[::7] = 0.0
    z[1::11] = 150.0           # beyond max_depth
    js2, jn2 = jrgbd._seed_frame(ja, jnp.int32(cur), jnp.asarray(z), 100.0)
    ts2, tn2 = trgbd._seed_frame(ta, cur, torch.as_tensor(z), 100.0)
    assert int(tn2) == int(jn2) > 0
    np.testing.assert_array_equal(ts2.kp2lm.numpy(), _np(js2.kp2lm))
    np.testing.assert_array_equal(ts2.lm_valid.numpy(), _np(js2.lm_valid))
    assert int(ts2.n_landmarks) == int(js2.n_landmarks)
    np.testing.assert_allclose(ts2.points.numpy(), _np(js2.points), rtol=1e-5, atol=1e-6)
