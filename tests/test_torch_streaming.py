"""The port's streaming reconstructor and ``resume_sfm`` on the CPU.

``StreamingReconstructor`` repeats the three cases of
``tests/test_streaming.py`` on the same 24 rendered frames (2.5 deg of orbit
per frame, 320x240, K=256): windows with a mid-stream checkpoint and
restore, the capacity guard, and the amortized finalize. The two packages
cannot share RANSAC draws, so they are held to outcomes: the registered
counts of the reference's test, and an ATE bound set by the reference's own
spread (MAX_ATE). The window's candidate pairs are the reference's, bit for
bit, on the same pooled descriptors.
"""

import numpy as np
import pytest
import torch

from eacham_tpu.sfm.streaming import StreamingReconstructor as JaxStreaming
from eacham_tpu_torch.sfm.pipeline import SfmOptions
from eacham_tpu_torch.sfm.streaming import StreamingReconstructor
from eacham_tpu_torch.utils.evaluate import ate_rmse
from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses, render_view

torch.set_num_threads(2)

SIZE = (320, 240)
# tests/test_streaming.py holds the reference to 0.08 at seed 0, where it
# ends at 0.073; at seeds 1 and 2 it ends at 0.103 and 0.081. The port ends
# at 0.091, 0.032, 0.047, 0.107 and 0.032 over seeds 0-4 (three windows of
# 8 with a finalize each, 2 threads). Both drift by as much over the 60 deg
# arc; the bound is the reference's spread with a margin.
MAX_ATE = 0.12


@pytest.fixture(scope="module")
def stream_scene():
    """tests/test_streaming.py's 24 frames."""
    rng = np.random.default_rng(7)
    W, H = SIZE
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = make_blob_scene(rng, n_blobs=600, depth=(3.0, 8.0), spread=2.2)
    poses = orbit_poses(24, radius=1.0, step_deg=2.5, advance=0.12)
    images = np.stack([render_view(blobs, T, intr, W, H) for T in poses])
    return images, poses, intr


def _opts():
    return SfmOptions(
        max_features=256, min_initial_inliers=40, min_matches=15,
        match_ratio=0.85, init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
        ransac_hyps_e=128, ransac_hyps_h=64, ransac_hyps_pnp=128,
        lm_capacity=4096, refine_max_iters=10, global_max_iters=20,
        local_ba_max_iters=4,
    )


def _ate(scene, poses_gt, n):
    valid = scene.pose_valid.numpy()[:n]
    est = scene.pose.numpy()[:n][valid]
    gt = poses_gt[valid]
    c_est = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("nij,ni->nj", gt[:, :3, :3], gt[:, :3, 3])
    return ate_rmse(c_est, c_gt)


def test_streaming_three_windows_with_checkpoint(stream_scene, tmp_path):
    images, poses_gt, intr = stream_scene
    rec = StreamingReconstructor(SIZE, intr=intr, options=_opts(), max_frames=32,
                                 window=8, retrieval_k=2, device="cpu")
    st1 = rec.process(images[:8])
    assert st1["arrived"] == 8
    assert st1.get("registered", 0) >= 6
    st2 = rec.process(images[8:16])
    assert st2["registered"] >= 14

    ckpt = tmp_path / "stream.npz"
    rec.checkpoint(ckpt)
    rec2 = StreamingReconstructor.restore(ckpt, SIZE, options=_opts(), window=8,
                                          retrieval_k=2, device="cpu")
    assert rec2.n_frames == 16 and rec2.initialized and rec2.names == rec.names
    assert torch.equal(rec2.desc, rec.desc) and np.array_equal(rec2.pooled, rec.pooled)

    st3 = rec2.process(images[16:24])
    assert st3["arrived"] == 24
    assert st3["registered"] >= 22
    assert _ate(rec2.scene, poses_gt, 24) < MAX_ATE
    # unarrived capacity rows stay unregistered
    assert not rec2.scene.pose_valid[24:].any()


def test_streaming_capacity_guard(stream_scene):
    images, _, intr = stream_scene
    rec = StreamingReconstructor(SIZE, intr=intr, options=_opts(), max_frames=8,
                                 window=3, retrieval_k=0, device="cpu")
    rec.process(images[:8])
    with pytest.raises(ValueError, match="capacity"):
        rec.process(images[8:16])


def test_streaming_amortized_finalize(stream_scene):
    images, poses_gt, intr = stream_scene
    rec = StreamingReconstructor(SIZE, intr=intr, options=_opts(), max_frames=32,
                                 window=8, retrieval_k=2, finalize_every=3, device="cpu")
    st1 = rec.process(images[:8])
    assert st1.get("finalized") is False
    st2 = rec.process(images[8:16])
    assert st2.get("finalized") is False
    st3 = rec.process(images[16:24])
    assert st3.get("finalized") is not False and st3["global_ba"] is not None
    assert st3["registered"] >= 21
    stf = rec.finalize()
    assert stf["registered"] >= 21
    assert _ate(rec.scene, poses_gt, 24) < MAX_ATE


@pytest.mark.parametrize("first,last", [(0, 1), (0, 8), (8, 16), (20, 24)])
def test_new_pairs_are_the_references(first, last):
    """Window and retrieval pairs of frames [first, last) on the same pooled
    descriptors: equal to the reference's, ties in ``argpartition`` included
    (frames 3 and 5 pool to the same vector)."""
    rng = np.random.default_rng(first)
    pooled = rng.normal(size=(32, 16)).astype(np.float32)
    pooled[5] = pooled[3]
    pooled /= np.linalg.norm(pooled, axis=1, keepdims=True)
    ref = JaxStreaming.__new__(JaxStreaming)
    port = StreamingReconstructor.__new__(StreamingReconstructor)
    for obj in (ref, port):
        obj.window, obj.retrieval_k, obj.pooled = 6, 2, pooled
    want = ref._new_pairs(first, last)
    got = port._new_pairs(first, last)
    assert got.dtype == want.dtype and np.array_equal(got, want)
