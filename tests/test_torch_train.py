"""The port's training path (eacham_tpu_torch.features.deep.train) against
the JAX package on the CPU, at a small size: 64x48 images, batch 2, 16
keypoints, one LightGlue layer.

* Data: the numpy generators give equal arrays from equal seeds.
* Losses at step 0: each of the three losses on parameters carried across
  by ``convert``, loss within 1e-4 relative and every gradient, brought
  back to the reference's layout, within 1e-3 of its leaf's max-abs. The
  reference's LightGlue losses live inside its trainers' jitted steps, so
  they are reached through the trainers themselves with ``jax.jit`` made
  the identity and ``jax.value_and_grad`` recording its result and
  stopping the run (``_reference_step0``).
* Optimiser: optax's schedule and clip, the ValueError of a short
  ``train_lightglue``.

Short runs of the trainers are in test_torch_train_runs.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eacham_tpu.features.deep import lightglue as jlg
from eacham_tpu.features.deep import superpoint as jsp
from eacham_tpu.features.deep import train as jt
from eacham_tpu.utils.synthetic import make_surface_scene
from eacham_tpu_torch import convert
from eacham_tpu_torch.features.deep import train as tt

from tests.test_torch_deep import WEIGHTS, _flat, _tree_like

torch.set_num_threads(2)

SMALL = dict(width=64, height=48)
KPS = 16


class _Stop(Exception):
    pass


class _JaxRecorder:
    """Stands in for ``jax`` inside the reference's train module: ``jit``
    is the identity with the step's arguments recorded, and
    ``value_and_grad`` records its result and stops the run."""

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        def run(*args):
            self.args = args
            return fn(*args)
        return run

    def value_and_grad(self, fn, has_aux=False):
        vg = jax.jit(jax.value_and_grad(fn, has_aux=has_aux))

        def run(p):
            self.out = vg(p)
            raise _Stop
        return run


def _reference_step0(monkeypatch, trainer, **kw):
    """(step arguments, ((loss, aux), grads)) of the reference trainer's
    first step."""
    rec = _JaxRecorder()
    monkeypatch.setattr(jt, "jax", rec)
    with pytest.raises(_Stop):
        trainer(**kw)
    monkeypatch.undo()
    return rec.args, rec.out


def _grads_flat(model, to_numpy):
    """The port's gradients in the reference's layout (zeros where the loss
    does not reach a parameter, as jax.grad gives)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return to_numpy(g)


def _check_grads(port, ref):
    """Every leaf within 1e-3 of its max-abs. The cross blocks' key biases
    have a gradient that is zero in exact arithmetic (without the rotary
    embedding, the bias adds one constant to all the scores of a query row,
    which its softmax does not see), so both sides hold only rounding noise
    there: each must stay under 1e-5 of the largest leaf's max-abs instead."""
    assert port.keys() == ref.keys()
    top = max(float(np.abs(v).max()) for v in ref.values())
    for k in ref:
        if k.startswith("['params']/['cross") and k.endswith("['k']/['bias']"):
            assert max(np.abs(port[k]).max(), np.abs(ref[k]).max()) < 1e-5 * top, k
            continue
        scale = float(np.abs(ref[k]).max())
        err = float(np.abs(port[k] - ref[k]).max())
        assert err <= 1e-3 * scale, (k, err, scale)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["blob", "surface", "mix"])
def test_make_batch_equals_reference(world):
    kw = dict(batch=2, max_kps=KPS, world=world, **SMALL)
    ref = jt.make_batch(np.random.default_rng(4), **kw)
    out = tt.make_batch(np.random.default_rng(4), **kw)
    assert out[5] == ref[5] == (64, 48)
    for a, b in zip(out[:5], ref[:5]):
        np.testing.assert_array_equal(a, b)
    assert out[4].any()


def test_synthetic_matches_equal_the_reference_generator(monkeypatch):
    """train_lightglue's batches over a whole run (clean third, ramp, full
    difficulty), as the reference's trainer feeds them to its step."""
    seen = []
    rec = _JaxRecorder()
    rec.jit = lambda fn: lambda *a: (seen.append(a[2:]) or (a[0], a[1], 0.0, (0.0, 0.0)))
    monkeypatch.setattr(jt, "jax", rec)
    jt.train_lightglue(steps=60, batch=2, n_kps=KPS, seed=5, params={"w": jnp.zeros(1)},
                       log_every=0)
    monkeypatch.undo()
    assert len(seen) == 60
    rng = np.random.default_rng(5)
    warm = 20
    for i, ref in enumerate(seen):
        ramp = min(1.0, max(0.0, (i - warm) / 20))
        # as the step receives them: fp32 (numpy promotes the descriptors)
        out = tt._as(tt.synthetic_matches(rng, 2, KPS, 0.1 + ramp * 0.4, ramp * 0.3), "cpu")
        for a, b in zip(out, ref):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (np.asarray(seen[-1][4]) < 0).any()


@pytest.mark.parametrize("world", ["blob", "surface"])
def test_sample_image_pair_equals_reference(world):
    ref = jt.sample_image_pair(np.random.default_rng(7), world=world, **SMALL)
    out = tt.sample_image_pair(np.random.default_rng(7), world=world, **SMALL)
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(out[i], ref[i])
    assert out[2].keys() == ref[2].keys()
    for k in ref[2]:
        np.testing.assert_array_equal(out[2][k], ref[2][k])


def test_render_pairs_task_equals_reference():
    """A worker's task: three pairs of the mix from one task seed."""
    task = (1234, 3, 64, 48, 70, True, "mix")
    ref = jt._render_pairs_task(task)
    out = tt._render_pairs_task(task)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        for i in (0, 1, 3, 4, 5):
            np.testing.assert_array_equal(o[i], r[i])
        assert o[2].keys() == r[2].keys()


@pytest.mark.parametrize("world", ["blob", "surface"])
def test_label_correspondence_equals_reference(world):
    """Random detections around the projected blobs of a rendered pair."""
    rng = np.random.default_rng(8)
    img0, img1, scene, T0, T1, intr = tt.sample_image_pair(rng, world=world, **SMALL)
    pc = scene["pts"] @ T0[:3, :3].T + T0[:3, 3]
    uv = pc[:, :2] / np.maximum(pc[:, 2:], 1e-6) * intr[:2] + intr[2:]
    inside = np.flatnonzero((uv[:, 0] > 0) & (uv[:, 0] < 64) & (uv[:, 1] > 0) & (uv[:, 1] < 48))
    xy0 = (uv[rng.choice(inside, 24)] + rng.normal(scale=2.0, size=(24, 2))).astype(np.float32)
    xy1 = (xy0 + rng.normal(scale=3.0, size=(24, 2))).astype(np.float32)[rng.permutation(24)]
    m0, m1 = rng.random(24) < 0.8, rng.random(24) < 0.8
    ref = jt._label_correspondence(xy0, m0, xy1, m1, scene, T0, T1, intr)
    out = tt._label_correspondence(xy0, m0, xy1, m1, scene, T0, T1, intr)
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).any() and (out < 0).any()


def test_flow_transfer_labels_are_geometrically_correct():
    """The port's copy of tests/test_deep.py's flow-transfer case: detected
    keypoints are labelled by their governing blob's sprite translation,
    never through the occluded far hemisphere of a surface world."""
    rng = np.random.default_rng(3)
    scene = make_surface_scene(rng, n_blobs=400)
    W, H = 160, 120
    f = 1.2 * W
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    center = np.array([0.0, 0.0, 9.0], np.float32)
    T0 = tt._orbit_pose(0.3, center, 14.0)
    T1 = tt._orbit_pose(0.3 + np.deg2rad(3.0), center, 14.0)
    np.testing.assert_array_equal(T0, jt._orbit_pose(0.3, center, 14.0))

    def project(T):
        pc = scene["pts"] @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = intr[0] * pc[:, 0] / z + intr[2]
        v = intr[1] * pc[:, 1] / z + intr[3]
        cam = -T[:3, :3].T @ T[:3, 3]
        vis = ((pc[:, 2] > 0.5) & (u > 5) & (u < W - 5) & (v > 5) & (v < H - 5)
               & (np.sum((scene["pts"] - center) * (cam - scene["pts"]), axis=1) > 0))
        return np.stack([u, v], -1), vis

    proj0, vis0 = project(T0)
    proj1, vis1 = project(T1)
    both = np.nonzero(vis0 & vis1)[0][:32]
    off = np.array([2.5, -1.5], np.float32)       # a texture corner off each center
    xy0 = (proj0[both] + off).astype(np.float32)
    perm = rng.permutation(len(both))
    xy1 = (proj1[both][perm] + off).astype(np.float32)
    m = np.ones(len(both), bool)
    gt = tt._label_correspondence(xy0, m, xy1, m, scene, T0, T1, intr)
    assert (gt >= 0).mean() > 0.9, f"labeled only {(gt >= 0).mean():.0%}"
    lab = gt >= 0
    assert (gt[lab] == np.argsort(perm)[lab]).all()


# --------------------------------------------------------------------------
# losses and gradients at step 0
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shipped_sp():
    with np.load(WEIGHTS / "superpoint.npz") as data:
        flat = {k: data[k].astype(np.float32) for k in data.files}
    like = jax.eval_shape(jsp.init_params, jax.random.PRNGKey(0))
    return _tree_like(like, flat), convert.superpoint_from_numpy(flat)


@pytest.fixture(scope="module")
def lg_one_layer():
    params = jax.jit(lambda k: jlg.init_params(k, n_layers=1, n_kps=KPS))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(9)
    # flax initialises biases to zero: fill them, or a lost bias would not show
    flat = {k: (rng.normal(scale=0.05, size=v.shape).astype(np.float32)
                if k.endswith("['bias']") else v) for k, v in _flat(params).items()}
    return _tree_like(params, flat), flat


@pytest.mark.parametrize("anchored", [False, True])
def test_sp_loss_and_gradients_match_reference(shipped_sp, anchored):
    """The anchor is a perturbed copy of the weights, so that the anchor
    term and its gradient are not zero."""
    jparams, model = shipped_sp
    img0, img1, kp0, kp1, mask, _ = jt.make_batch(
        np.random.default_rng(10), batch=2, max_kps=KPS, **SMALL)
    anchor_j = anchor_t = None
    if anchored:
        rng = np.random.default_rng(11)
        flat = {k: v + rng.normal(scale=0.01, size=v.shape).astype(np.float32)
                for k, v in convert.superpoint_to_numpy(model).items()}
        anchor_j, anchor_t = _tree_like(jparams, flat), convert.superpoint_from_numpy(flat)
    (l_ref, aux_ref), g_ref = jax.jit(jax.value_and_grad(
        lambda p, a: jt._sp_loss(p, *map(jnp.asarray, (img0, img1, kp0, kp1, mask)),
                                 anchor_params=a), has_aux=True))(jparams, anchor_j)
    net = copy.deepcopy(model).requires_grad_(True)
    l, aux = tt._sp_loss(net, *tt._as((img0, img1, kp0, kp1, mask), "cpu"),
                         anchor_params=anchor_t)
    l.backward()
    for key in ("det", "desc", "anchor"):
        np.testing.assert_allclose(float(aux[key]), float(aux_ref[key]), rtol=1e-4)
    np.testing.assert_allclose(float(l), float(l_ref), rtol=1e-4)
    assert (float(aux["anchor"]) > 0) == anchored
    _check_grads(_grads_flat(net, convert.superpoint_to_numpy), _flat(g_ref))


def test_lightglue_loss_and_gradients_match_reference(monkeypatch, lg_one_layer):
    jparams, flat = lg_one_layer
    args, ((l_ref, aux_ref), g_ref) = _reference_step0(
        monkeypatch, jt.train_lightglue, steps=60, batch=2, n_layers=1, n_kps=KPS, seed=12,
        params=jparams, log_every=0)
    net = convert.lightglue_from_numpy(flat, 1).requires_grad_(True)
    l, aux = tt.lightglue_loss(net, *tt._as(args[2:], "cpu"))
    l.backward()
    np.testing.assert_allclose(float(l), float(l_ref), rtol=1e-4)
    np.testing.assert_allclose([float(a) for a in aux], [float(a) for a in aux_ref], rtol=1e-4)
    _check_grads(_grads_flat(net, convert.lightglue_to_numpy), _flat(g_ref))


def _sp_batch_pairs(n_steps, seed=13):
    """Rendered pairs of the mix, one list a step."""
    rng = np.random.default_rng(seed)
    return [tt.render_pair_batch(rng, 2, world="mix", **SMALL) for _ in range(n_steps)]


def test_lightglue_sp_loss_and_gradients_match_reference(monkeypatch, shipped_sp, lg_one_layer):
    """The reference's trainer extracts and labels with its own
    make_sp_batch; the port's loss takes the batch its step received. The
    port's make_sp_batch on the same pairs gives that batch: keypoints
    within 1e-3 px (3e-5 normalized by the half-width 32), descriptors within
    1e-4, equal masks and labels."""
    jsp_params, sp_model = shipped_sp
    jparams, flat = lg_one_layer
    pairs = _sp_batch_pairs(1)[0]
    monkeypatch.setattr(jt, "render_pair_batch", lambda *a, **k: pairs)
    args, ((l_ref, aux_ref), g_ref) = _reference_step0(
        monkeypatch, jt.train_lightglue_sp, sp_params=jsp_params, steps=4, batch=2,
        n_layers=1, seed=14, params=jparams, n_kps=KPS, world="mix", log_every=0, **SMALL)
    batch = [np.asarray(a) for a in args[2:]]
    assert batch[2].sum() < batch[2].size and (batch[6] >= 0).any()
    ours = tt.make_sp_batch(sp_model, None, max_kps=KPS, pairs=pairs, **SMALL)
    for i, tol in ((0, 3e-5), (1, 1e-4), (3, 3e-5), (4, 1e-4)):
        live = batch[2] if i < 3 else batch[5]
        np.testing.assert_allclose(ours[i][live], batch[i][live], atol=tol)
    for i in (2, 5, 6):
        np.testing.assert_array_equal(ours[i], batch[i])

    net = convert.lightglue_from_numpy(flat, 1).requires_grad_(True)
    l, aux = tt.lightglue_sp_loss(net, *tt._as(batch, "cpu"))
    l.backward()
    np.testing.assert_allclose(float(l), float(l_ref), rtol=1e-4)
    np.testing.assert_allclose([float(a) for a in aux], [float(a) for a in aux_ref], rtol=1e-4)
    _check_grads(_grads_flat(net, convert.lightglue_to_numpy), _flat(g_ref))


# --------------------------------------------------------------------------
# optimiser
# --------------------------------------------------------------------------

@pytest.mark.parametrize("recipe, steps, lr", [
    ("lightglue", 2500, 3e-4),     # scripts/train_deep.py
    ("lightglue", 300, 3e-4),      # train_lightglue's defaults
    ("lightglue_sp", 400, 2e-4),   # scripts/train_mix_driver.sh's chunk
    ("lightglue_sp", 16, 2e-4),    # a short run
])
def test_schedules_equal_optax(recipe, steps, lr):
    """At every update count, as the reference builds them
    (eacham_tpu/features/deep/train.py, train_lightglue and
    train_lightglue_sp). Optax computes in fp32: its values carry rounding
    of about 1e-6 of the peak (the cosine near its end), hence rtol 1e-6 and
    atol 1e-6 x lr; the port computes in float64."""
    if recipe == "lightglue":
        ref = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=max(50, steps // 20), decay_steps=max(steps, 1))
        ours = tt.lightglue_schedule(steps, lr)
    else:
        warmup = min(max(20, steps // 20), max(steps // 2, 1))
        ref = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
            end_value=lr * 0.2)
        ours = tt.lightglue_sp_schedule(steps, lr)
    counts = np.arange(steps + 2)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts)))
    got = np.array([ours(int(c)) for c in counts])
    assert got[0] == 0.0 == want[0]          # the first update runs at lr 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * lr)


def test_short_train_lightglue_raises_as_the_reference():
    """steps <= 50: the warm-up (at least 50) is not shorter than the run."""
    for steps in (3, 50):
        with pytest.raises(ValueError, match="decay_steps"):
            jt.train_lightglue(steps=steps, params={"w": jnp.zeros(1)})
        with pytest.raises(ValueError, match="decay_steps"):
            tt.train_lightglue(steps=steps, device="cpu")


@pytest.mark.parametrize("norm", [0.5, 1.0, 3.0])
def test_clip_by_global_norm_equals_optax(norm):
    rng = np.random.default_rng(15)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    if norm == 1.0:                          # a global norm of exactly 1
        leaves = [np.array([[1, 0, 0, 0]], np.float32), np.zeros(5, np.float32),
                  np.zeros((2, 2, 2), np.float32)]
    else:
        total = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in leaves))
        leaves = [(x / total * norm).astype(np.float32) for x in leaves]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x) for x in leaves], None)
    grads = [torch.tensor(x) for x in leaves]
    n = tt.clip_by_global_norm_(grads, 1.0)
    np.testing.assert_allclose(float(n), norm, rtol=1e-6)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    if norm <= 1.0:
        for g, x in zip(grads, leaves):
            np.testing.assert_array_equal(g.numpy(), x)
