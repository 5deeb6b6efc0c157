"""The port's deep frontend (eacham_tpu_torch.features.deep + convert)
against the JAX package on the CPU: the weight converter, the
SuperPoint-class network and extraction, and the LightGlue-class matcher,
on random parameters and on the shipped weights.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: both sides are fp32; convolutions and matrix products differ
in summation order only, which shows as ~2e-6 on heatmaps and ~1e-5 on
assignment scores.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.features.deep import lightglue as jlg
from eacham_tpu.features.deep import superpoint as jsp
from eacham_tpu.utils.synthetic import render_sequence
from eacham_tpu_torch import convert
from eacham_tpu_torch.features.deep import frontend as tfe
from eacham_tpu_torch.features.deep import lightglue as lg
from eacham_tpu_torch.features.deep import superpoint as sp

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parent.parent / "weights"


def _flat(params):
    """A parameter tree of the reference, keyed as its save_params writes it."""
    return {"/".join(str(k) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _tree_like(like, flat):
    """``flat`` (fp32) back into the structure of ``like``."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat["/".join(str(k) for k in kp)], jnp.float32)
                  for kp, _ in paths])


@pytest.fixture(scope="module")
def sp_random():
    params = jsp.init_params(jax.random.PRNGKey(0))
    # biases are initialised to zero: fill them, or a lost bias would not show
    flat = {k: (np.random.default_rng(1).normal(scale=0.1, size=v.shape).astype(np.float32)
                if k.endswith("['bias']") else v) for k, v in _flat(params).items()}
    return _tree_like(params, flat), convert.superpoint_from_numpy(flat)


@pytest.fixture(scope="module")
def sp_shipped():
    with np.load(WEIGHTS / "superpoint.npz") as data:
        flat = {k: data[k] for k in data.files}
    like = jax.eval_shape(jsp.init_params, jax.random.PRNGKey(0))
    return _tree_like(like, flat), convert.superpoint_from_numpy(flat)


@pytest.fixture(scope="module")
def lg_random():
    params = jlg.init_params(jax.random.PRNGKey(0), n_layers=2, n_kps=32)
    rng = np.random.default_rng(2)
    flat = {k: (rng.normal(scale=0.1, size=v.shape).astype(np.float32)
                if k.endswith("['bias']") else v) for k, v in _flat(params).items()}
    return _tree_like(params, flat), convert.lightglue_from_numpy(flat, n_layers=2)


@pytest.fixture(scope="module")
def lg_shipped():
    with np.load(WEIGHTS / "lightglue.npz") as data:
        flat = {k: data[k] for k in data.files}
    like = jax.eval_shape(lambda k: jlg.init_params(k, n_layers=3), jax.random.PRNGKey(0))
    return _tree_like(like, flat), convert.lightglue_from_numpy(flat, n_layers=3)


@pytest.fixture(scope="module")
def frames():
    images, _, _ = render_sequence(np.random.default_rng(6), n_frames=2, width=320, height=240)
    return images.astype(np.float32)


@pytest.mark.parametrize("weights", ["random", "shipped"])
@pytest.mark.parametrize("size", [(64, 96), (240, 320)])
def test_superpoint_net_parity(weights, size, request, frames):
    """Heatmap (the 65-way softmax and the cell unpack, element for
    element) and descriptor field, atol 1e-5."""
    jparams, model = request.getfixturevalue(f"sp_{weights}")
    H, W = size
    images = (frames[:1] if size == (240, 320)
              else np.random.default_rng(3).random((1, H, W)).astype(np.float32))
    heat_ref, desc_ref = jsp.SuperPointNet().apply(jparams, jnp.asarray(images))
    with torch.no_grad():
        heat, desc = model(torch.as_tensor(images))
    assert heat.shape == (1, H, W) and desc.shape == (1, H // 8, W // 8, 256)
    np.testing.assert_allclose(heat.numpy(), np.asarray(heat_ref), atol=1e-5)
    np.testing.assert_allclose(desc.numpy(), np.asarray(desc_ref), atol=1e-5)


def test_converter_refuses_wrong_weights(sp_shipped):
    with np.load(WEIGHTS / "superpoint.npz") as data:
        flat = {k: data[k] for k in data.files}
    missing = dict(flat)
    del missing["['params']/['det2']/['bias']"]
    with pytest.raises(KeyError):
        convert.superpoint_from_numpy(missing)
    with pytest.raises(ValueError):
        convert.superpoint_from_numpy({**flat, "['params']/['extra']/['bias']": np.zeros(3)})
    with pytest.raises(ValueError):
        convert.lightglue_from_numpy(
            {k: v for k, v in np.load(WEIGHTS / "lightglue.npz").items()}, n_layers=2)


def _align_slots(xy_ref, xy, score_ref):
    """Slot of ``xy`` nearest to each slot of ``xy_ref`` (one frame). Top-k
    orders keypoints by score; two scores closer than the packages'
    rounding difference may swap slots, so slots are compared by position
    and a swap is allowed only between such neighbours."""
    d = np.linalg.norm(xy_ref[:, None] - xy[None], axis=-1)
    perm = d.argmin(1)
    assert len(set(perm.tolist())) == len(perm)
    moved = np.flatnonzero(perm != np.arange(len(perm)))
    assert len(moved) <= 0.05 * len(perm)
    assert np.all(np.abs(score_ref[moved] - score_ref[perm[moved]]) < 1e-5)
    return perm


@pytest.mark.parametrize("refine", [True, False])
def test_extract_deep_parity(sp_shipped, frames, refine):
    """Live-slot xy within 1e-3 px, descriptors within 1e-4, equal masks
    (no score of these frames lies within 1e-4 of the threshold)."""
    jparams, model = sp_shipped
    K = 384
    xy_r, desc_r, score_r, mask_r = (np.asarray(a) for a in jsp.extract_deep(
        jparams, jnp.asarray(frames), max_keypoints=K, refine=refine))
    if refine:
        out = tfe.extract_deep_batch(model, frames, max_keypoints=K, device="cpu")
    else:
        out = sp.extract_deep(model, torch.as_tensor(frames), max_keypoints=K, refine=False)
    xy, desc, score, mask = (a.numpy() for a in out)
    assert xy.shape == (2, K, 2) and desc.shape == (2, K, 256)
    assert np.all(np.abs(score_r[score_r > 0] - 0.05) > 1e-4)
    assert mask_r.sum() > 300
    for b in range(2):
        live = mask_r[b]
        perm = _align_slots(xy_r[b][live], xy[b][mask[b]], score_r[b][live])
        np.testing.assert_allclose(xy[b][mask[b]][perm], xy_r[b][live], atol=1e-3)
        np.testing.assert_allclose(desc[b][mask[b]][perm], desc_r[b][live], atol=1e-4)
        np.testing.assert_allclose(score[b][mask[b]][perm], score_r[b][live], atol=1e-5)
        assert mask[b].sum() == live.sum()
    if not refine:
        assert np.abs(xy[mask] - np.rint(xy[mask])).max() < 1e-6


def test_frame_chunk_moves_keypoints_below_the_parity_tolerance(sp_shipped, frames):
    """The frame batch changes the convolutions' summation order; the
    keypoints move by less than the 1e-3 px the parity test allows."""
    _, model = sp_shipped
    a = tfe.extract_deep_batch(model, frames, max_keypoints=256, frame_chunk=1, device="cpu")
    b = tfe.extract_deep_batch(model, frames, max_keypoints=256, frame_chunk=2, device="cpu")
    for n in range(2):
        perm = _align_slots(a[0][n].numpy(), b[0][n].numpy(), a[2][n].numpy())
        assert np.abs(a[0][n].numpy() - b[0][n].numpy()[perm]).max() < 1e-3


def test_pad_images_for_conv():
    img = torch.rand(2, 30, 45)
    out = tfe.pad_images_for_conv(img)
    assert out.shape == (2, 32, 48)
    assert torch.equal(out[:, :30, :45], img) and float(out[:, 30:].abs().max()) == 0.0
    assert tfe.pad_images_for_conv(out) is out


def test_normalize_keypoints_and_rotary():
    uv = np.array([[0.0, 0.0], [640.0, 480.0], [320.0, 240.0]], np.float32)
    out = lg.normalize_keypoints(torch.as_tensor(uv), 640, 480).numpy()
    np.testing.assert_allclose(out, np.asarray(jlg.normalize_keypoints(jnp.asarray(uv), 640, 480)),
                               atol=1e-7)
    np.testing.assert_allclose(out[0], [-1.0, -0.75], atol=1e-6)
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (2, 5, 2)).astype(np.float32)
    x = rng.normal(size=(2, 4, 5, 64)).astype(np.float32)
    ang = lg._rotary(torch.as_tensor(coords))
    assert ang.shape == (2, 5, 32)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jlg._rotary(jnp.asarray(coords))), atol=1e-4)
    np.testing.assert_allclose(
        lg._apply_rotary(torch.as_tensor(x), ang).numpy(),
        np.asarray(jlg._apply_rotary(jnp.asarray(x), jlg._rotary(jnp.asarray(coords)))), atol=1e-4)


def _random_sets(seed, B=2, N=32):
    rng = np.random.default_rng(seed)
    kps0 = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    kps1 = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    d0 = rng.normal(size=(B, N, 256)).astype(np.float32)
    d1 = rng.normal(size=(B, N, 256)).astype(np.float32)
    m0 = np.ones((B, N), bool)
    m0[0, -5:] = False
    m1 = np.ones((B, N), bool)
    m1[1, :3] = False
    return kps0, d0, m0, kps1, d1, m1


def test_matcher_parity_two_layers_random_params(lg_random):
    """similarity logits atol 1e-3 (they reach a few tens and pass two
    transformer layers), matchabilities and assignment scores atol 1e-4,
    equal decisions."""
    jparams, model = lg_random
    args = _random_sets(0)
    jargs = tuple(jnp.asarray(a) for a in args)
    sim_r, m0_r, m1_r = jlg.LightGlueMatcher(n_layers=2).apply(
        jparams, *jargs, method=jlg.LightGlueMatcher.similarity)
    idx_r, valid_r, scores_r = jlg.match_deep(jparams, *jargs, n_layers=2)
    targs = tuple(torch.as_tensor(a) for a in args)
    with torch.no_grad():
        sim, m0, m1 = model.similarity(*targs)
    idx, valid, scores = lg.match_deep(model, *targs)
    live = args[2][:, :, None] & args[5][:, None, :]
    np.testing.assert_allclose(sim.numpy()[live], np.asarray(sim_r)[live], atol=1e-3)
    assert np.all(sim.numpy()[~live] == -1e9)
    np.testing.assert_allclose(m0.numpy(), np.asarray(m0_r), atol=1e-4)
    np.testing.assert_allclose(m1.numpy(), np.asarray(m1_r), atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_r), atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()], np.asarray(idx_r)[valid.numpy()])
    assert idx.dtype == torch.int32 and not valid.numpy()[0, -5:].any()
    assert np.all(scores.numpy()[1, :, :3] == 0)


def test_matcher_parity_shipped_weights_on_extracted_features(sp_shipped, lg_shipped, frames):
    """The shipped 3-layer matcher on SuperPoint features of two rendered
    views (the reference's features go into both packages): scores atol
    1e-4, idx equal where both valid, valid agreement >= 0.99."""
    jsp_params, _ = sp_shipped
    jparams, model = lg_shipped
    xy, desc, _, mask = jsp.extract_deep(jsp_params, jnp.asarray(frames), max_keypoints=384)
    kps = jlg.normalize_keypoints(xy, 320.0, 240.0)
    idx_r, valid_r, scores_r = jlg.match_deep(
        jparams, kps[:1], desc[:1], mask[:1], kps[1:], desc[1:], mask[1:],
        n_layers=3, threshold=0.15)
    t = [torch.as_tensor(np.asarray(a)) for a in (kps, desc, mask)]
    idx, valid, scores = lg.match_deep(model, t[0][:1], t[1][:1], t[2][:1],
                                       t[0][1:], t[1][1:], t[2][1:], threshold=0.15)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_r), atol=1e-4)
    vr, vt = np.asarray(valid_r), valid.numpy()
    assert (vr == vt).mean() >= 0.99 and vr.sum() > 100
    both = vr & vt
    np.testing.assert_array_equal(idx.numpy()[both], np.asarray(idx_r)[both])


def test_matcher_mask_invariance(lg_random):
    """Padded-slot contents must not affect live outputs."""
    _, model = lg_random
    rng = np.random.default_rng(0)
    kps = torch.as_tensor(rng.uniform(-1, 1, (1, 32, 2)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(1, 32, 256)).astype(np.float32))
    m = torch.ones((1, 32), dtype=torch.bool)
    m[0, 20:] = False
    _, _, s1 = lg.match_deep(model, kps, d, m, kps, d, m)
    dg, kg = d.clone(), kps.clone()
    dg[0, 20:] = 999.0
    kg[0, 20:] = -77.0
    _, _, s2 = lg.match_deep(model, kg, dg, m, kg, dg, m)
    np.testing.assert_allclose(s1.numpy()[0, :20, :20], s2.numpy()[0, :20, :20], atol=1e-5)


def test_load_frontend_params_shipped_and_fallback(tmp_path):
    """The shipped files load through numpy alone and are named on the
    modules; an empty directory falls back to a seeded random
    initialisation and says so."""
    superpoint, matcher, n_layers = tfe.load_frontend_params(device="cpu")
    assert n_layers == 3 and matcher.n_layers == 3
    assert superpoint.weights_path == str(WEIGHTS / "superpoint.npz")
    assert matcher.weights_path == str(WEIGHTS / "lightglue.npz")
    with np.load(WEIGHTS / "lightglue.npz") as data:
        np.testing.assert_array_equal(
            matcher.self0_0.q.weight.numpy(), data["['params']/['self0_0']/['q']/['kernel']"].T)
    assert not any(p.requires_grad for p in matcher.parameters())

    a = tfe.load_frontend_params(tmp_path, device="cpu")
    b = tfe.load_frontend_params(tmp_path, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    assert a[0].weights_path is None and a[1].weights_path is None and a[2] == 3
    for pa, pb in zip(a[1].parameters(), b[1].parameters()):
        assert torch.equal(pa, pb)
    assert float(a[1].desc_sim_gain) == 5.0 and float(a[0].det1.weight.std()) > 0


def test_match_images_e2e_agrees_with_the_two_call_path(frames):
    superpoint, matcher, _ = tfe.load_frontend_params(device="cpu")
    uv0, uv1, valid, mscore = tfe.match_images_e2e(superpoint, matcher, frames,
                                                   max_keypoints=256, device="cpu")
    v = valid.numpy()
    assert v.sum() >= 30 and np.all(mscore.numpy()[v] > 0.5)
    xy, desc, _, mask = tfe.extract_deep_batch(superpoint, frames, max_keypoints=256,
                                               device="cpu")
    kn = lg.normalize_keypoints(xy, 320.0, 240.0)
    idx, valid2, _ = lg.match_deep(matcher, kn[:1], desc[:1], mask[:1],
                                   kn[1:], desc[1:], mask[1:])
    assert torch.equal(valid, valid2[0])
    assert torch.equal(uv1[valid], xy[1][idx[0].long()][valid])
