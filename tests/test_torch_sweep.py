"""The slice as a whole: ``run_sfm`` of the port against the JAX package's
on one small synthetic sequence (12 frames, 160 points, exact tables made
from a seed with numpy), each with its own random stream, on the CPU.

The two packages cannot share RANSAC draws, so they are held to outcomes:
every frame registered and an ATE under 0.02 (the trajectory is 2.75 long;
keypoints carry 0.3 px of noise at a focal length of 240). The port's two
loop forms must agree on the registered count. Sharding without a process
group of that size raises a ``ValueError`` that says how to launch (the
sharded path itself runs in tests/test_torch_parallel.py);
``checkpoint_path`` is carried and writes the scene between segments, and
explicit map-refinement rounds run."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eacham_tpu.sfm import SfmOptions as JaxOptions, run_sfm as jax_run_sfm
from eacham_tpu_torch.sfm import device_loop as tloop
from eacham_tpu_torch.sfm import pipeline as tpipe
from eacham_tpu_torch.sfm.scene import frame_pair_table
from eacham_tpu_torch.utils.evaluate import trajectory_ate

torch.set_num_threads(2)

N_FRAMES, N_PTS, SIZE = 12, 160, (320, 240)
MAX_ATE = 0.02
OPTS = dict(min_initial_inliers=40, min_matches=16, init_min_tri_angle_deg=0.5,
            min_tri_angle_deg=0.5, ransac_hyps_e=64, ransac_hyps_h=32, ransac_hyps_pnp=64,
            lm_capacity=1024, refine_max_iters=5, global_max_iters=12, local_ba_max_iters=4,
            local_ba_every=2, sweep_segment=4, interim_ba_iters=3)


@pytest.fixture(scope="module")
def sequence():
    """A camera moving sideways past a point cloud: keypoint slot k of
    every frame is point k, with noisy per-frame views of its descriptor,
    so that the matcher's ratio and mutual tests do real work."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (N_PTS, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    f = 240.0
    intr = np.array([f, f, SIZE[0] / 2, SIZE[1] / 2], np.float32)
    Ts = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    for i in range(N_FRAMES):
        a = 0.04 * i
        c, s = np.cos(a), np.sin(a)
        Ts[i, :3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        Ts[i, :3, 3] = [0.25 * i, 0.01 * i, 0.02 * i]
    pc = np.einsum("nij,pj->npi", Ts[:, :3, :3], pts) + Ts[:, None, :3, 3]
    uv = np.stack([f * pc[..., 0] / pc[..., 2] + intr[2],
                   f * pc[..., 1] / pc[..., 2] + intr[3]], -1)
    uv = (uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
    vis = pc[..., 2] > 0.1
    dsc = rng.normal(size=(N_PTS, 256)).astype(np.float32)
    dsc = dsc[None] + rng.normal(scale=0.03, size=(N_FRAMES, N_PTS, 256)).astype(np.float32)
    dsc /= np.linalg.norm(dsc, axis=-1, keepdims=True)
    return uv, dsc, vis, intr, Ts


def _ate(pose, pose_valid, Ts):
    return trajectory_ate(pose[pose_valid], Ts[pose_valid])


@pytest.fixture(scope="module")
def port_runs(sequence):
    uv, dsc, vis, intr, _ = sequence
    return {dl: tpipe.run_sfm(uv, dsc, vis, SIZE, intr=intr,
                              options=tpipe.SfmOptions(device_loop=dl, **OPTS), device="cpu")
            for dl in (True, False)}


def test_reference_registers_every_frame(sequence):
    uv, dsc, vis, intr, Ts = sequence
    scene, stats = jax_run_sfm(jnp.asarray(uv), jnp.asarray(dsc), jnp.asarray(vis),
                               image_size=SIZE, intr=jnp.asarray(intr),
                               options=JaxOptions(**OPTS), verbose=False)
    assert stats["registered"] == N_FRAMES
    assert _ate(np.asarray(scene.pose), np.asarray(scene.pose_valid), Ts) < MAX_ATE


@pytest.mark.parametrize("device_loop", [True, False])
def test_port_registers_every_frame(sequence, port_runs, device_loop):
    Ts = sequence[4]
    scene, stats = port_runs[device_loop]
    assert stats["initialized"] and stats["registered"] == N_FRAMES and stats["excluded"] == 0
    assert stats["landmarks"] == int(scene.lm_valid.sum()) > 100
    assert _ate(scene.pose.numpy(), scene.pose_valid.numpy(), Ts) < MAX_ATE
    ba = stats["global_ba"]
    assert ba is not None and ba["final_cost"] < ba["initial_cost"] and ba["iterations"] >= 1
    assert set(stats["seconds"]) >= {"match_graph", "init_pair", "seed", "sweep", "finalize"}
    assert bool(scene.pose.isfinite().all()) and bool(scene.points.isfinite().all())


def test_both_loop_forms_agree_on_the_registered_count(port_runs):
    assert port_runs[True][1]["registered"] == port_runs[False][1]["registered"]


def test_absolute_anchors_pull_the_trajectory_onto_the_references(sequence):
    """Anchors on the true poses, in the reconstruction's own frame (frame
    i0 at the identity, the init pair's baseline as the unit)."""
    uv, dsc, vis, intr, Ts = sequence
    opt = tpipe.SfmOptions(**OPTS)
    base, stats = tpipe.run_sfm(uv, dsc, vis, SIZE, intr=intr, options=opt, device="cpu")
    i0, j0 = stats["init_pair"]
    rel = Ts @ np.linalg.inv(Ts[i0])
    scale = np.linalg.norm(base.pose[j0, :3, 3].numpy()) / np.linalg.norm(rel[j0, :3, 3])
    anchors = rel.copy()
    anchors[:, :3, 3] *= scale
    mask = np.ones(N_FRAMES, bool)
    scene, _ = tpipe.run_sfm(uv, dsc, vis, SIZE, intr=intr, options=opt, device="cpu",
                             abs_anchors=(anchors.astype(np.float32), mask))
    err = np.abs(scene.pose.numpy()[:, :3, 3] - anchors[:, :3, 3]).max()
    err0 = np.abs(base.pose.numpy()[:, :3, 3] - anchors[:, :3, 3]).max()
    assert err < 0.02 and err <= err0 + 1e-6, (err, err0)


def test_sweep_step_limit_segments_and_exclusion(sequence):
    """``max_steps`` stops the sweep with ``more`` set; segments call
    ``on_segment`` between them and not after the last; a frame whose PnP
    cannot reach ``min_pnp_inliers`` is excluded, not registered."""
    uv, dsc, vis, intr, _ = sequence
    opt = tpipe.SfmOptions(**OPTS)
    scene, stats = tpipe.initialize_sfm(uv, dsc, vis, SIZE, intr=intr, options=opt, device="cpu")
    assert stats["initialized"]
    fp = torch.as_tensor(frame_pair_table(scene.pair_idx.numpy(), N_FRAMES))
    excluded = torch.zeros(N_FRAMES, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    kw = dict(n_hyp_pnp=64, ba_cfg=tpipe._ba_configs(opt)[0], ba_every=2)
    s1, ex1, n1, more = tloop.registration_sweep_step(
        scene, excluded, fp, g, opt.max_repr_error, opt.min_tri_angle, max_steps=3, **kw)
    assert (n1, more, int(s1.pose_valid.sum()), int(ex1.sum())) == (3, True, 5, 0)
    calls = []

    def on_segment(s):
        calls.append(int(s.pose_valid.sum()))
        return s

    s2, ex2, n2 = tloop.registration_sweep(
        scene, excluded, fp, g, opt.max_repr_error, opt.min_tri_angle, segment=4,
        on_segment=on_segment, **kw)
    assert n2 == N_FRAMES - 2 and int(s2.pose_valid.sum()) == N_FRAMES
    assert calls == [6, 10]
    s3, ex3, n3 = tloop.registration_sweep(
        scene, excluded, fp, g, opt.max_repr_error, opt.min_tri_angle,
        min_pnp_inliers=10 ** 6, **kw)
    assert n3 == 0 and int(ex3.sum()) == N_FRAMES - 2 and int(s3.pose_valid.sum()) == 2


def test_what_is_not_ported_raises(sequence, tmp_path):
    """Sharding without a process group raises; checkpoints and the
    map-refinement rounds are carried (the loop-closing stage, which needs
    long-range edges, runs in tests/test_torch_loop.py)."""
    uv, dsc, vis, intr, Ts = sequence

    def run(**kw):
        return tpipe.run_sfm(uv, dsc, vis, SIZE, intr=intr, device="cpu",
                             options=tpipe.SfmOptions(**{**OPTS, **kw}))

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        run(n_devices=2)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        tpipe._mesh(tpipe.SfmOptions(n_devices=4), torch.device("cpu"))
    # scene checkpoints are ported: the sweep writes one between segments
    ckpt = tmp_path / "scene.npz"
    scene, stats = run(checkpoint_path=str(ckpt))
    assert stats["registered"] == N_FRAMES and stats["checkpoints"] >= 2 and ckpt.exists()
    # explicit map-refinement rounds run, each a rebuild, a prune and a BA
    scene, stats = run(map_refine_rounds=2)
    assert stats["registered"] == N_FRAMES and len(stats["map_refine"]) == 2
    assert all(r["ba"] is not None and r["landmarks"] > 0 for r in stats["map_refine"])
    valid = scene.pose_valid.numpy()
    assert trajectory_ate(scene.pose.numpy()[valid], Ts[valid]) < MAX_ATE
    # a windowed run without long-range edges (span > 30) enters neither the
    # loop-closing stage nor, by the AUTO rule, the refinement rounds
    scene, stats = run(pair_window=3, pair_ladder=False)
    assert stats["registered"] == N_FRAMES
    assert "loop" not in stats and stats["map_refine"] == []


def test_run_sfm_refuses_a_missing_card(sequence):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    uv, dsc, vis, intr, _ = sequence
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_sfm(uv, dsc, vis, SIZE, intr=intr, options=tpipe.SfmOptions(**OPTS))


@pytest.mark.slow
def test_bench_workload_passes_the_gate_on_the_cpu():
    """The 100-frame bench workload through ``extract_features`` and
    ``run_sfm`` on the CPU: bench.py's gate (95 of 100 frames, ATE < 0.1)."""
    import bench_gpu
    from eacham_tpu_torch.features.frontend import extract_features

    images, poses, intr = bench_gpu.render_workload(np.random.default_rng(0))
    xy, desc, _, mask = extract_features(images, max_keypoints=bench_gpu.MAX_KPS, device="cpu")
    scene, stats = tpipe.run_sfm(
        xy, desc, mask, (bench_gpu.WIDTH, bench_gpu.HEIGHT), intr=intr, device="cpu",
        options=tpipe.SfmOptions(**bench_gpu.BENCH_OPTIONS))
    assert stats["registered"] >= bench_gpu.MIN_REGISTERED
    assert bench_gpu.scene_ate(scene, poses) < bench_gpu.MAX_ATE
