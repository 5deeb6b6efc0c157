"""The port's ``parallel/`` over ``torch.distributed``: two gloo ranks on the
CPU, spawned by ``torch.multiprocessing`` and joined through a ``file://``
store in the test's temporary directory (no TCP port to clash between
test workers), against the single-process port and the JAX package.

One spawn runs every two-rank case and saves each rank's results; the
tests read them. Tolerances: the sharded matcher equals the unsharded one
exactly (the pairs are only split); the sharded BA sums its observations
in another order, so it is held to 1e-4 of the single-process BA (relative
and absolute: the points lie at depth 4-6).
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from tests.test_torch_ba import make_problem

torch.set_num_threads(2)

WORLD = 2
# the scene of tests/test_parallel.py::test_run_sfm_mesh_parity
N_FRAMES, N_PTS, F = 8, 160, 120.0
SFM_OPTS = dict(min_initial_inliers=40, min_matches=16, init_min_tri_angle_deg=0.5,
                min_tri_angle_deg=0.5, ransac_hyps_e=64, ransac_hyps_h=32, ransac_hyps_pnp=64,
                lm_capacity=1024, refine_max_iters=5, global_max_iters=8,
                local_ba_max_iters=4)
BA_ITERS = 20


def _match_inputs():
    rng = np.random.default_rng(0)
    N, K, D = 6, 64, 256
    desc = rng.normal(size=(N, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    desc[1, :32] = desc[0, :32]
    desc[3, :40] = desc[2, :40]
    mask = np.ones((N, K), bool)
    mask[4, 50:] = False
    return desc, mask


def _sfm_inputs():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (N_PTS, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    intr = np.array([F, F, 80.0, 60.0], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    for i in range(N_FRAMES):
        a = 0.04 * i
        c, s = np.cos(a), np.sin(a)
        poses[i, :3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        poses[i, :3, 3] = [0.25 * i, 0.01 * i, 0.02 * i]
    pc = np.einsum("nij,pj->npi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([F * pc[..., 0] / pc[..., 2] + intr[2],
                   F * pc[..., 1] / pc[..., 2] + intr[3]], -1).astype(np.float32)
    vis = pc[..., 2] > 0.1
    desc = rng.normal(size=(N_PTS, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    desc = np.broadcast_to(desc, (N_FRAMES, N_PTS, 64)).copy()
    return uv, desc, vis, intr, poses


def _cases():
    """name -> what each rank computes, run with the mesh given."""
    from eacham_tpu_torch import convert
    from eacham_tpu_torch.ba.core import BAConfig
    from eacham_tpu_torch.parallel import match_all_pairs_sharded, refine_ba_sharded
    from eacham_tpu_torch.sfm.matches import all_pairs_index
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm

    def match(mesh):
        desc, mask = _match_inputs()
        pairs = torch.as_tensor(all_pairs_index(desc.shape[0]))
        return match_all_pairs_sharded(torch.as_tensor(desc), torch.as_tensor(mask), pairs,
                                       mesh, min_matches=20, chunk=4)

    def ba(anchors):
        def run(mesh):
            prob = convert.ba_problem_from_numpy(make_problem(anchors=anchors)[0], device="cpu")
            poses, points, intr, info = refine_ba_sharded(prob, BAConfig(max_iters=BA_ITERS),
                                                          mesh)
            return poses, points, intr, info["final_cost"]
        return run

    def sfm(mesh):
        uv, desc, vis, intr, _ = _sfm_inputs()
        scene, stats = run_sfm(uv, desc, vis, (160, 120), intr=intr, device="cpu",
                               options=SfmOptions(n_devices=mesh.world_size, **SFM_OPTS))
        return scene.pose, scene.pose_valid, scene.points, stats["registered"]

    def sfm_parted(mesh):
        """A sweep in segments of two frames, with interim BAs between
        them, in which rank 1's sweep parts from rank 0's: its first PnP
        fails (it excludes a frame that rank 0 registers), and from its
        third next-best-view on it finds no candidate (left to itself it
        would stop after one segment, while rank 0 goes on)."""
        from eacham_tpu_torch.sfm import device_loop

        nbv, pnp = device_loop.next_best_view, device_loop.pnp_register
        step = device_loop.registration_sweep_step
        calls = {"nbv": 0, "pnp": 0, "segments": 0}
        parted = mesh.rank == 1

        def counted_step(*a, **k):
            calls["segments"] += 1
            return step(*a, **k)

        def counted_view(scene, excluded):
            calls["nbv"] += 1
            prev, cur, score = nbv(scene, excluded)
            if parted and calls["nbv"] > 2:
                score = torch.full_like(score, -1)
            return prev, cur, score

        def counted_pnp(*a, **k):
            calls["pnp"] += 1
            T, n_inl = pnp(*a, **k)
            return T, (0 if parted and calls["pnp"] == 1 else n_inl)

        device_loop.next_best_view, device_loop.pnp_register = counted_view, counted_pnp
        device_loop.registration_sweep_step = counted_step
        try:
            uv, desc, vis, intr, _ = _sfm_inputs()
            scene, stats = run_sfm(
                uv, desc, vis, (160, 120), intr=intr, device="cpu",
                options=SfmOptions(n_devices=mesh.world_size, sweep_segment=2, **SFM_OPTS))
        finally:
            device_loop.next_best_view, device_loop.pnp_register = nbv, pnp
            device_loop.registration_sweep_step = step
        return (scene.pose, scene.pose_valid, scene.points, stats["registered"],
                stats["excluded"], calls)

    return {"match": match, "ba": ba(False), "ba_anchors": ba(True), "sfm": sfm,
            "sfm_parted": sfm_parted}


def _rank_main(rank, init_file, out_dir):
    """One rank: join the group, run every case, save the results."""
    torch.set_num_threads(1)
    from eacham_tpu_torch.parallel import init_distributed, make_mesh

    import torch.distributed as dist

    assert init_distributed(f"file://{init_file}", WORLD, rank, device="cpu") is True
    mesh = make_mesh(WORLD, device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.shape) == (WORLD, rank, {"shard": WORLD})
    out = {name: fn(mesh) for name, fn in _cases().items()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of every case, from one spawn of two processes."""
    d = tmp_path_factory.mktemp("gloo")
    ctx = tmp.spawn(_rank_main, args=(str(d / "store"), str(d)), nprocs=WORLD, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two gloo ranks did not finish in 240 s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """Every case in this process alone (the mesh of one rank, no group)."""
    from eacham_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    assert mesh.group is None and mesh.world_size == 1
    return {name: fn(mesh) for name, fn in _cases().items()}


def test_init_distributed_is_a_noop_without_configuration(monkeypatch):
    from eacham_tpu_torch.parallel import init_distributed

    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed(device="cpu") is False


def test_make_mesh_without_a_group_of_that_size_says_how_to_launch():
    from eacham_tpu_torch.parallel import make_mesh, make_mesh_2d, mesh_axes

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        make_mesh_2d(2, 4, device="cpu")
    mesh = make_mesh_2d(1, 1, device="cpu")
    assert mesh_axes(mesh) == (("dcn", "ici"), 1) and mesh.shape == {"dcn": 1, "ici": 1}


def test_sharded_matching_equals_the_single_process_port_and_the_reference(ranks, single):
    """Both ranks return the full tables, equal to one process's and, on
    every decision, to the JAX package's ``match_all_pairs``."""
    import jax.numpy as jnp

    from eacham_tpu.features.matching import match_all_pairs as jax_match
    from eacham_tpu.sfm.matches import all_pairs_index

    desc, mask = _match_inputs()
    mj_r, mv_r, ok_r = (np.asarray(x) for x in jax_match(
        jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(all_pairs_index(6)),
        min_matches=20, chunk=4))
    mj1, mv1, ok1 = (x.numpy() for x in single["match"])
    assert ok1.any() and mv1.sum() > 60
    for r in range(WORLD):
        mj, mv, ok = (x.numpy() for x in ranks[r]["match"])
        np.testing.assert_array_equal(mj, mj1)
        np.testing.assert_array_equal(mv, mv1)
        np.testing.assert_array_equal(ok, ok1)
        np.testing.assert_array_equal(mv, mv_r)
        np.testing.assert_array_equal(ok, ok_r)
        np.testing.assert_array_equal(mj[mv], mj_r[mv_r])


@pytest.mark.parametrize("case", ["ba", "ba_anchors"])
def test_sharded_ba_equals_the_single_process_ba(ranks, single, case):
    """Poses, points, intrinsics and the final cost within 1e-4 (relative
    and absolute) of one process's BA (the shards only change the order of
    the sums), equal on both ranks; the anchored cameras end at their
    anchors."""
    poses1, points1, intr1, cost1 = single[case]
    for r in range(WORLD):
        poses, points, intr, cost = ranks[r][case]
        assert torch.isfinite(poses).all()
        torch.testing.assert_close(poses, poses1, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(points, points1, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(intr, intr1, rtol=1e-4, atol=1e-4)
        assert abs(float(cost) - float(cost1)) <= 1e-4 * max(float(cost1), 1.0)
    for a, b in zip(ranks[0][case], ranks[1][case]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    if case == "ba_anchors":
        d, gt = make_problem(anchors=True)
        on = d["abs_mask"] & d["cam_in_ba"]      # (the last camera is out of the BA)
        assert np.abs(ranks[0][case][0].numpy()[on] - gt[on]).max() < 5e-2


def test_run_sfm_on_two_ranks(ranks, single):
    """``run_sfm(n_devices=2)``: both ranks end with the same scene, as many
    frames registered as the one-process run, ATE < 0.02 (the reference's
    bound for its mesh run)."""
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    *_, gt = _sfm_inputs()
    pose1, valid1, _, reg1 = single["sfm"]
    assert reg1 >= N_FRAMES - 1
    for a, b in zip(ranks[0]["sfm"], ranks[1]["sfm"]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    pose, valid, _, reg = ranks[0]["sfm"]
    assert reg == reg1
    v, v1 = valid.numpy(), valid1.numpy()
    assert trajectory_ate(pose.numpy()[v], gt[v]) < 0.02
    assert trajectory_ate(pose1.numpy()[v1], gt[v1]) < 0.02


def test_run_sfm_on_two_ranks_whose_sweeps_part(ranks, single):
    """The ranks' sweeps part (rank 1's is perturbed, as ranks on cards of
    other models could): the run still ends on both ranks, rank 0's decisions
    and state hold, and both ranks return the same scene and statistics as
    the one-process run of the same options."""
    *_, gt = _sfm_inputs()
    pose1, valid1, points1, reg1, excl1, _ = single["sfm_parted"]
    assert reg1 >= N_FRAMES - 1 and excl1 == 0
    *r0, calls0 = ranks[0]["sfm_parted"]
    *r1, calls1 = ranks[1]["sfm_parted"]
    for a, b in zip(r0, r1):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    pose, valid, points, reg, excl = r0
    assert (reg, excl) == (reg1, excl1)
    assert torch.equal(valid, valid1)
    # rank 1 went on sweeping (finding nothing) for as many segments as rank
    # 0: left to itself it would have stopped at its third view, in segment 2
    assert calls1["segments"] == calls0["segments"] == 4
    assert calls1["nbv"] > 3
    v = valid.numpy()
    from eacham_tpu_torch.utils.evaluate import trajectory_ate
    assert trajectory_ate(pose.numpy()[v], gt[v]) < 0.02
