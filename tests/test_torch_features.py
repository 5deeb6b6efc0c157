"""Parity of the port's feature frontend (eacham_tpu_torch.features) with
the JAX package on the CPU: the same rendered frames through both
``extract_features``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.features.frontend import extract_features as jax_extract
from eacham_tpu.utils import synthetic as jsyn
from eacham_tpu_torch.features import detector as tdet
from eacham_tpu_torch.features.frontend import extract_features
from eacham_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

W, H, K = 160, 120, 128


def _frames(syn):
    rng = np.random.default_rng(1)
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = syn.make_blob_scene(rng, n_blobs=300, depth=(3.0, 8.0), spread=1.5)
    poses = syn.orbit_poses(2, radius=0.8, step_deg=2.0, advance=0.1)
    return np.stack([syn.render_view(blobs, T, intr, W, H) for T in poses])


@pytest.fixture(scope="module")
def images():
    return _frames(jsyn)


def test_synthetic_copy_renders_the_same(images):
    """The port's numpy copy of utils/synthetic.py draws the same frames."""
    np.testing.assert_array_equal(_frames(tsyn), images)


def test_extract_features_parity(images):
    """Equal keypoint masks, keypoints within 1e-3 px and descriptors
    within 1e-4 (fp32 convolutions in both; sums in another order)."""
    xy_r, desc_r, score_r, mask_r = jax_extract(jnp.asarray(images), max_keypoints=K)
    xy, desc, score, mask = extract_features(images, max_keypoints=K, device="cpu")
    assert xy.shape == (2, K, 2) and desc.shape == (2, K, 256)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_r))
    assert int(mask.sum()) > K          # both frames hold well over K/2 keypoints
    np.testing.assert_allclose(xy.numpy(), np.asarray(xy_r), atol=1e-3)
    np.testing.assert_allclose(desc.numpy(), np.asarray(desc_r), atol=1e-4)
    np.testing.assert_allclose(score.numpy(), np.asarray(score_r), rtol=1e-4, atol=1e-6)


def test_frame_chunking_does_not_change_the_result(images):
    """The convolutions' summation order depends on the batch size, so the
    chunked run is held to the parity tolerances, masks exactly."""
    xy1, desc1, _, mask1 = extract_features(images, max_keypoints=K, frame_chunk=1,
                                            device="cpu")
    xy2, desc2, _, mask2 = extract_features(images, max_keypoints=K, frame_chunk=8,
                                            device="cpu")
    assert torch.equal(mask1, mask2)
    torch.testing.assert_close(xy1, xy2, rtol=0, atol=1e-3)
    torch.testing.assert_close(desc1, desc2, rtol=0, atol=1e-4)


def test_top_k_stable_breaks_ties_like_lax_top_k():
    """``lax.top_k`` sends ties to the lower index; ``torch.topk`` promises
    no order among them, so the detector sorts stably instead."""
    rng = np.random.default_rng(2)
    score = rng.integers(0, 5, size=(3, 400)).astype(np.float32)
    score[:, ::7] = -np.inf
    val_r, idx_r = jax.lax.top_k(jnp.asarray(score), 64)
    val, idx = tdet.top_k_stable(torch.as_tensor(score), 64)
    np.testing.assert_array_equal(val.numpy(), np.asarray(val_r))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
