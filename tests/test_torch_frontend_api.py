"""The rest of the port's public frontend API against the JAX package on the
same rendered frames, on the CPU: the per-image ``detect_keypoints`` and
``describe_keypoints``, ``ClassicalFrontend``, the single-pair
``features.matching.match_pair``, and the two utilities ``utils.viz`` and
``utils.profiling``.

Tolerances are the ones already held for the frontend (ROADMAP section 3):
equal keypoint masks, keypoints within 1e-3 px, descriptors within 1e-4
(fp32 convolutions in both, summed in another order). ``match_pair`` is the
batched matcher's per-pair function in bf16 where the reference's CPU path
is fp32, so decisions must agree on more than 0.995 of the keypoints; the
port's own single call must equal the same pair inside a batched call bit
for bit. ``draw_matches`` is byte-equal.

The ``cuda`` test runs only where a card is present:

    python -m pytest --noconftest -m cuda tests/test_torch_frontend_api.py
"""

import numpy as np
import pytest
import torch

from eacham_tpu_torch import features as tfeat
from eacham_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

W, H, K = 160, 120, 128


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = tsyn.make_blob_scene(rng, n_blobs=300, depth=(3.0, 8.0), spread=1.5)
    poses = tsyn.orbit_poses(3, radius=0.8, step_deg=2.0, advance=0.1)
    return np.stack([tsyn.render_view(blobs, T, intr, W, H) for T in poses])


def test_detect_and_describe_keypoints_equal_the_reference(images):
    import jax.numpy as jnp

    from eacham_tpu.features import describe_keypoints as jax_describe
    from eacham_tpu.features import detect_keypoints as jax_detect

    xy_r, sidx_r, score_r, mask_r = (np.asarray(x) for x in jax_detect(
        jnp.asarray(images[0]), max_keypoints=K))
    xy, sidx, score, mask = tfeat.detect_keypoints(images[0], max_keypoints=K, device="cpu")
    assert xy.shape == (K, 2) and sidx.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), mask_r)
    assert int(mask.sum()) > K // 2
    np.testing.assert_allclose(xy.numpy(), xy_r, atol=1e-3)
    np.testing.assert_array_equal(sidx.numpy()[mask_r], sidx_r[mask_r])
    np.testing.assert_allclose(score.numpy(), score_r, rtol=1e-4, atol=1e-6)

    # the same keypoints described by both packages
    desc_r = np.asarray(jax_describe(jnp.asarray(images[0]), jnp.asarray(xy_r),
                                     jnp.asarray(sidx_r), jnp.asarray(mask_r)))
    desc = tfeat.describe_keypoints(images[0], xy_r, sidx_r, mask_r, device="cpu")
    assert desc.shape == (K, 256)
    np.testing.assert_allclose(desc.numpy(), desc_r, atol=1e-4)
    norms = torch.linalg.vector_norm(desc, dim=-1)
    assert torch.allclose(norms[mask], torch.ones(()), atol=1e-5)
    assert not desc[~mask].any()


def test_classical_frontend_pads_the_last_chunk_as_the_reference(images):
    """Three frames in batches of two: the last chunk is padded with a blank
    frame and cut off again; every output within the frontend tolerance of
    the reference's ``ClassicalFrontend`` and of the port's own
    ``extract_features``."""
    import jax.numpy as jnp

    from eacham_tpu.features import ClassicalFrontend as JaxFrontend

    ref = [np.asarray(x) for x in JaxFrontend(max_keypoints=K, batch=2)(jnp.asarray(images))]
    front = tfeat.ClassicalFrontend(max_keypoints=K, batch=2, device="cpu")
    out = [x.numpy() for x in front(images)]
    whole = [x.numpy() for x in tfeat.extract_features(images, max_keypoints=K, device="cpu")]
    for got in (out, whole):
        assert got[0].shape == (3, K, 2) and got[1].shape == (3, K, 256)
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_allclose(got[0], ref[0], atol=1e-3)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-4, atol=1e-6)


def _pair_inputs():
    """Frames 0 and 1 of a table with different live counts (K1=200 of 256
    slots, K2=150), descriptors sharing 120 nearly equal rows."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(2, 256, 256)).astype(np.float32)
    d[1, :120] = d[0, 40:160] + rng.normal(scale=0.15, size=(120, 256))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mask = np.ones((2, 256), bool)
    mask[0, 190:] = False
    mask[1, 10:14] = False
    return d, mask


def test_match_pair_agrees_with_the_reference():
    import jax.numpy as jnp

    from eacham_tpu.features import match_pair as jax_match_pair

    d, mask = _pair_inputs()
    K1, K2 = 200, 150
    args = (d[0, :K1], d[1, :K2], mask[0, :K1], mask[1, :K2])
    j_r, v_r = (np.asarray(x) for x in jax_match_pair(*(jnp.asarray(a) for a in args)))
    j, v = tfeat.match_pair(*(torch.as_tensor(a) for a in args))
    assert j.shape == (K1,) and v.shape == (K1,) and j.dtype == torch.int32
    j, v = j.numpy(), v.numpy()
    assert v_r.sum() > 80
    assert (v == v_r).mean() > 0.995
    both = v & v_r
    np.testing.assert_array_equal(j[both], j_r[both])


def test_match_pair_equals_the_pair_inside_a_batched_call():
    """Padding to the larger K (with dead keypoints) changes neither the
    quantization nor the live lanes' indices: the single call gives the
    same bits as pair (0, 1) of the batched call on the full table, whose
    dead slots hold real descriptors."""
    d, mask = _pair_inputs()
    K1, K2 = 200, 150
    dm = mask.copy()
    dm[0, K1:] = False
    dm[1, K2:] = False
    j, v = tfeat.match_pair(torch.as_tensor(d[0, :K1]), torch.as_tensor(d[1, :K2]),
                            torch.as_tensor(dm[0, :K1]), torch.as_tensor(dm[1, :K2]))
    jb, vb, _ = tfeat.match_all_pairs(torch.as_tensor(d), torch.as_tensor(dm),
                                      torch.tensor([[0, 1]], dtype=torch.int32), min_matches=0)
    assert int(v.sum()) > 80
    assert torch.equal(v, vb[0, :K1])
    assert torch.equal(j[v], jb[0, :K1][v])


@pytest.mark.cuda
def test_match_pair_launches_the_batched_kernel_once_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eacham_tpu_torch import ops

    d, mask = _pair_inputs()
    args = [torch.as_tensor(a, device="cuda") for a in (d[0, :200], d[1, :150],
                                                        mask[0, :200], mask[1, :150])]
    ops.reset_launch_counts()
    j, v = tfeat.match_pair(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"match_pairs": 1, "masked_attention": 0, "match_pair": 0}
    j_cpu, v_cpu = tfeat.match_pair(*(a.cpu() for a in args))
    assert (v.cpu() == v_cpu).float().mean() > 0.999


def test_draw_matches_is_byte_equal_to_the_reference(tmp_path):
    from eacham_tpu.utils.viz import draw_matches as jax_draw
    from eacham_tpu_torch.utils.viz import draw_matches

    rng = np.random.default_rng(5)
    img1 = rng.random((40, 60)).astype(np.float32)
    img2 = rng.random((50, 70)).astype(np.float32) * 1.3 - 0.1
    uv1 = rng.uniform(-5, 65, (30, 2)).astype(np.float32)
    uv2 = rng.uniform(-5, 75, (30, 2)).astype(np.float32)
    valid = rng.random(30) > 0.3
    got = draw_matches(img1, img2, uv1, uv2, valid, path=tmp_path / "m.png")
    want = jax_draw(img1, img2, uv1, uv2, valid, path=tmp_path / "r.png")
    assert got.shape == (50, 130, 3) and got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert (tmp_path / "m.png").read_bytes() == (tmp_path / "r.png").read_bytes()


def test_memory_summary_and_device_trace_on_the_cpu(tmp_path):
    from eacham_tpu_torch.utils import device_trace, memory_summary

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    text = memory_summary()
    assert text and all("memory stats unavailable" in line for line in text.splitlines())
    with device_trace(tmp_path / "trace") as logdir:
        (torch.ones(64) * 2).sum()
    files = list((tmp_path / "trace").glob("trace-*.json"))
    assert logdir == str(tmp_path / "trace") and len(files) == 1
    assert files[0].stat().st_size > 0
