"""The long-trajectory path of the port end to end on the CPU: a windowed
``run_sfm`` whose long-range edges take it through the loop-closing stage
(PnP loop measurements, the consistency gate, the pose-graph solve and its
gate) and the three map-refinement rounds, as the JAX package's does; the
``resume_sfm`` of such a scene; absolute anchors.

The sequence: 40 frames on a closing inward orbit (radius 8, one turn, a
small vertical wobble) around 200 points on a sphere of radius 2, each
point seen from the side it faces; keypoint slot k is point k with noisy
per-frame views of its descriptor (0.3 px pixel noise), so the matcher's
ratio and mutual tests do real work. With ``pair_window`` 3 and
``pair_retrieval_k`` 2, retrieval pairs the last frames with the first ones
(spans above 30: the long-range edges). ``pgo_min_consistency_deg=0`` lets
the solve and its gate run however small the drift.

The two packages cannot share RANSAC draws, so they are held to outcomes:
every frame registered, an ATE under 0.05 (0.6% of the orbit's radius;
both measured at 0.021), long-range edges present, the loop stage entered
and three refinement rounds run."""

import dataclasses

import numpy as np
import pytest
import torch

from eacham_tpu_torch.sfm import pipeline as tpipe
from eacham_tpu_torch.utils.evaluate import trajectory_ate

torch.set_num_threads(2)

N_FRAMES, N_PTS, SIZE = 40, 200, (320, 240)
MAX_ATE = 0.05
OPTS = dict(min_initial_inliers=40, min_matches=16, init_min_tri_angle_deg=0.5,
            min_tri_angle_deg=0.5, ransac_hyps_e=64, ransac_hyps_h=32, ransac_hyps_pnp=64,
            lm_capacity=4096, refine_max_iters=5, global_max_iters=12, local_ba_max_iters=4,
            local_ba_every=2, sweep_segment=16, interim_ba_iters=3,
            pair_window=3, pair_retrieval_k=2, loop_close=True, pgo_min_consistency_deg=0.0)


def orbit(n, radius=8.0):
    """World->camera poses on a closed circle around the origin, looking at it."""
    Ts = []
    for i in range(n):
        a = np.deg2rad(360.0 * i / n)
        cam = radius * np.array([np.sin(a), 0.15 * np.sin(3 * a), -np.cos(a)])
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ cam
        Ts.append(T)
    return np.stack(Ts).astype(np.float32)


def make_sequence(seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(N_PTS, 3))
    nrm[:, 1] *= 0.5
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pts = (2.0 * nrm + rng.normal(scale=0.1, size=(N_PTS, 3))).astype(np.float32)
    f = 200.0
    intr = np.array([f, f, SIZE[0] / 2, SIZE[1] / 2], np.float32)
    Ts = orbit(N_FRAMES)
    pc = np.einsum("nij,pj->npi", Ts[:, :3, :3], pts) + Ts[:, None, :3, 3]
    uv = np.stack([f * pc[..., 0] / pc[..., 2] + intr[2],
                   f * pc[..., 1] / pc[..., 2] + intr[3]], -1)
    uv = (uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
    cams = -np.einsum("nji,nj->ni", Ts[:, :3, :3], Ts[:, :3, 3])
    facing = np.einsum("pi,npi->np", nrm, cams[:, None, :] - pts[None]) > 0
    inside = ((uv[..., 0] > 0) & (uv[..., 0] < SIZE[0])
              & (uv[..., 1] > 0) & (uv[..., 1] < SIZE[1]))
    vis = facing & inside & (pc[..., 2] > 0.1)
    dsc = rng.normal(size=(N_PTS, 256)).astype(np.float32)
    dsc = dsc[None] + rng.normal(scale=0.03, size=(N_FRAMES, N_PTS, 256)).astype(np.float32)
    dsc /= np.linalg.norm(dsc, axis=-1, keepdims=True)
    return uv, dsc, vis, intr, Ts


@pytest.fixture(scope="module")
def sequence():
    return make_sequence()


@pytest.fixture(scope="module")
def port_run(sequence):
    uv, dsc, vis, intr, _ = sequence
    return tpipe.run_sfm(uv, dsc, vis, SIZE, intr=intr, device="cpu",
                         options=tpipe.SfmOptions(**OPTS))


def check_outcome(registered, ate, n_far, refine_rounds):
    assert registered == N_FRAMES, registered
    assert ate < MAX_ATE, ate
    assert n_far > 0
    assert refine_rounds == 3


def test_run_sfm_closes_the_loop(sequence, port_run):
    _, _, _, _, Ts = sequence
    scene, stats = port_run
    valid = scene.pose_valid.numpy()
    ate = trajectory_ate(scene.pose.numpy()[valid], Ts[valid])
    loop = stats["loop"]
    check_outcome(stats["registered"], ate, loop["n_far"], len(stats["map_refine"]))
    # every surviving edge longer than the window was measured; the gate ran
    assert loop["loop_rows"] >= loop["n_far"] and np.isfinite(loop["err0"])
    assert loop["decision"] in ("accepted", "rejected") and loop["err_pgo"] is not None
    assert set(loop["seconds"]) >= {"measure", "edges", "solve"}
    for r in stats["map_refine"]:
        assert r["ba"]["final_cost"] < r["ba"]["initial_cost"] and r["landmarks"] > 100
    assert stats["seconds"]["loop"] > 0
    assert bool(scene.points[scene.lm_valid].isfinite().all())


@pytest.mark.slow
def test_reference_run_sfm_closes_the_loop(sequence):
    """The JAX package on the same sequence and options (about a minute on
    the CPU, mostly compilation)."""
    import jax.numpy as jnp

    from eacham_tpu.sfm import SfmOptions, run_sfm

    uv, dsc, vis, intr, Ts = sequence
    scene, stats = run_sfm(jnp.asarray(uv), jnp.asarray(dsc), jnp.asarray(vis), SIZE,
                           intr=jnp.asarray(intr), options=SfmOptions(**OPTS), verbose=False)
    valid = np.asarray(scene.pose_valid)
    pi = np.asarray(scene.pair_idx)
    span = np.abs(pi[:, 1] - pi[:, 0])
    n_far = int((np.asarray(scene.pair_ok) & (span > 30)).sum())
    check_outcome(stats["registered"], trajectory_ate(np.asarray(scene.pose)[valid], Ts[valid]),
                  n_far, 3)


def test_host_loop_runs_the_refinement_rounds(sequence):
    """``device_loop=False`` has no loop-closing stage (as in the
    reference) but its finalization runs the AUTO refinement rounds."""
    uv, dsc, vis, intr, Ts = sequence
    scene, stats = tpipe.run_sfm(uv[:36], dsc[:36], vis[:36], SIZE, intr=intr, device="cpu",
                                 options=tpipe.SfmOptions(**{**OPTS, "device_loop": False}))
    assert "loop" not in stats and len(stats["map_refine"]) == 3
    valid = scene.pose_valid.numpy()
    assert stats["registered"] == 36
    assert trajectory_ate(scene.pose.numpy()[valid], Ts[:36][valid]) < MAX_ATE


def test_resume_of_a_windowed_scene(sequence, port_run):
    """A ``finalize=False`` resume of a windowed scene with long-range
    edges (``map_refine_rounds`` at its default -1) sweeps and returns;
    with ``finalize=True`` the AUTO rule runs the three refinement rounds
    there too."""
    _, _, _, _, Ts = sequence
    scene, _ = port_run
    drop = torch.arange(N_FRAMES) >= 30
    partial = scene._replace(pose_valid=scene.pose_valid & ~drop,
                             kp2lm=torch.where(drop[:, None], -1, scene.kp2lm))
    opt = tpipe.SfmOptions(**OPTS)
    assert opt.map_refine_rounds == -1
    swept, st = tpipe.resume_sfm(partial, options=opt, verbose=False, finalize=False,
                                 device="cpu")
    assert st["finalized"] is False and st["registered"] == N_FRAMES
    assert "map_refine" not in st
    final, st2 = tpipe.resume_sfm(partial, options=opt, verbose=False, finalize=True,
                                  device="cpu")
    assert st2["registered"] == N_FRAMES and len(st2["map_refine"]) == 3
    valid = final.pose_valid.numpy()
    assert trajectory_ate(final.pose.numpy()[valid], Ts[valid]) < MAX_ATE
    # sharding needs a process group of that size, launched by torchrun
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tpipe.resume_sfm(partial, options=dataclasses.replace(opt, n_devices=2),
                         verbose=False, device="cpu")


def test_anchors_in_estimate_frame_equals_the_reference(port_run, sequence):
    """The anchors that express ground-truth poses in the estimate's frame,
    from tensors in the port and arrays in the reference, agree to 1e-6;
    the estimate's own poses come back as themselves."""
    from eacham_tpu.sfm.anchors import anchors_in_estimate_frame as jax_anchors
    from eacham_tpu_torch.sfm import anchors_in_estimate_frame

    _, _, _, _, Ts = sequence
    scene, _ = port_run
    ids = [0, 13, 27, 39]
    a_t, m_t = anchors_in_estimate_frame(scene.pose, Ts, ids, valid=scene.pose_valid)
    a_j, m_j = jax_anchors(scene.pose.numpy(), Ts, ids, valid=scene.pose_valid.numpy())
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m_t, m_j)
    assert a_t.dtype == np.float32 and m_t.sum() == len(ids)
    # anchors of the estimate itself are the estimate (a similarity of identity)
    a_s, _ = anchors_in_estimate_frame(scene.pose, scene.pose, ids)
    np.testing.assert_allclose(a_s[ids], scene.pose.numpy()[ids], atol=1e-4)
