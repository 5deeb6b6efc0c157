"""Short runs of the port's trainers (eacham_tpu_torch.features.deep.train)
against the JAX package's on the CPU, at test_torch_train.py's small size:
each trainer in both packages on the same batches from the same start, the
per-step losses within 1e-3 relative; frozen modules bit-identical after a
head-only run; the anchor term 0 at step 0; the port's loss falls over the
clean first third of a 60-update run.
"""

import copy
import os

import numpy as np
import torch

from eacham_tpu.features.deep import train as jt
from eacham_tpu_torch import convert
from eacham_tpu_torch.features.deep import train as tt
from eacham_tpu_torch.features.deep.frontend import load_frontend_params

from tests.test_torch_deep_params import _weights_digest
from tests.test_torch_train import KPS, SMALL, lg_one_layer, shipped_sp  # noqa: F401 (fixtures)

torch.set_num_threads(2)

DIGEST_AT_IMPORT = _weights_digest()


def test_short_train_lightglue_follows_reference(lg_one_layer):
    """52 updates (the shortest run the schedule allows), the same batches
    from the same seed and the same start: per-step losses within 1e-3."""
    jparams, flat = lg_one_layer
    kw = dict(steps=52, batch=2, n_layers=1, n_kps=KPS, seed=16, log_every=0)
    _, ref = jt.train_lightglue(params=jparams, **kw)
    _, ours = tt.train_lightglue(params=convert.lightglue_from_numpy(flat, 1), device="cpu",
                                 **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-3)


def test_short_train_superpoint_follows_reference(shipped_sp):
    jparams, model = shipped_sp
    kw = dict(steps=2, batch=2, lr=1e-3, seed=17, log_every=0, max_kps=KPS, **SMALL)
    _, ref = jt.train_superpoint(params=jparams, **kw)
    _, ours = tt.train_superpoint(params=model, device="cpu", **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-3)


def test_short_train_lightglue_sp_follows_reference(monkeypatch, lg_one_layer):
    """Three updates on the same extracted batches (the port's
    make_sp_batch feeds both trainers; the extraction is held above)."""
    jparams, flat = lg_one_layer
    sp_model, _, _ = load_frontend_params(device="cpu")
    rng = np.random.default_rng(18)
    batches = [tt.make_sp_batch(sp_model, rng, batch=2, max_kps=KPS, world="mix", **SMALL)
               for _ in range(3)]
    feed_j, feed_t = iter(batches), iter(batches)
    monkeypatch.setattr(jt, "make_sp_batch", lambda *a, **k: next(feed_j))
    monkeypatch.setattr(tt, "make_sp_batch", lambda *a, **k: next(feed_t))
    kw = dict(steps=3, batch=2, n_layers=1, seed=19, n_kps=KPS, log_every=0, world="mix", **SMALL)
    _, ref = jt.train_lightglue_sp(None, params=jparams, **kw)
    _, ours = tt.train_lightglue_sp(sp_model, params=convert.lightglue_from_numpy(flat, 1),
                                    device="cpu", **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-3)


def test_head_only_superpoint_keeps_frozen_modules_and_anchor_starts_at_zero(shipped_sp):
    _, shipped = shipped_sp
    img0, img1, kp0, kp1, mask, _ = tt.make_batch(
        np.random.default_rng(20), batch=2, max_kps=KPS, **SMALL)
    _, aux = tt._sp_loss(shipped, *tt._as((img0, img1, kp0, kp1, mask), "cpu"),
                         anchor_params=copy.deepcopy(shipped))
    assert aux["anchor"].item() == 0.0
    model, losses = tt.train_superpoint(
        steps=2, batch=2, seed=20, params=shipped, trainable={"det1", "det2"},
        anchor_params=shipped, log_every=0, device="cpu", max_kps=KPS, **SMALL)
    assert np.isfinite(losses).all()
    before, after = dict(shipped.named_parameters()), dict(model.named_parameters())
    for name, p in after.items():
        same = torch.equal(p, before[name])
        assert same == (name.split(".")[0] not in ("det1", "det2")), name


def test_port_train_lightglue_loss_falls_over_the_clean_third():
    """60 updates from init_params at the recipe's peak lr 3e-4: the mean
    loss of updates 15-19 below that of updates 0-4, both inside the clean
    first third (steps // 3 = 20)."""
    _, losses = tt.train_lightglue(steps=60, batch=2, n_layers=1, n_kps=KPS, seed=21,
                                   log_every=0, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[15:20]) < np.mean(losses[0:5]), losses[:20]


def test_render_pool_feeds_each_step_its_task_seed(monkeypatch):
    """workers=1: the spawned worker renders step i's pairs from the i-th
    task seed drawn from the trainer's generator, as the reference's pool
    does; the worker's initializer hides every card."""
    seen = []
    real = tt.make_sp_batch

    def record(*a, pairs=None, **k):
        seen.append(pairs)
        return real(*a, pairs=pairs, **k)

    monkeypatch.setattr(tt, "make_sp_batch", record)
    sp_model, _, _ = load_frontend_params(device="cpu")
    _, losses = tt.train_lightglue_sp(sp_model, steps=2, batch=2, n_layers=1, seed=22,
                                      n_kps=KPS, log_every=0, world="mix", workers=1,
                                      device="cpu", **SMALL)
    assert np.isfinite(losses).all() and len(seen) == 2
    seeds = np.random.default_rng(22).integers(2 ** 31, size=2)
    for pairs, seed in zip(seen, seeds):
        want = tt._render_pairs_task((int(seed), 2, 64, 48, 70, True, "mix"))
        for got, ref in zip(pairs, want):
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[4], ref[4])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    tt._pool_worker_init()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""


def test_trainers_leave_the_shipped_weights_untouched():
    assert DIGEST_AT_IMPORT and _weights_digest() == DIGEST_AT_IMPORT
