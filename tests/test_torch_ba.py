"""The port's bundle adjustment (eacham_tpu_torch.ba.core) against the JAX
package's on the same problems, made from a seed with numpy and carried
across with ``convert.ba_problem_from_numpy`` (CPU, small size).

The two optimizers take their own accept/reject sequences (their sums run
in different orders), so results are compared where they end: final cost
to rel 1e-3, poses to 1e-3. The ``cuda`` test runs only where a card is
present, and imports JAX nowhere:

    python -m pytest --noconftest -m cuda tests/test_torch_ba.py
"""

import numpy as np
import pytest
import torch

from eacham_tpu_torch import convert
from eacham_tpu_torch.ba import core as tba

torch.set_num_threads(2)


def _scene_np(rng, n_cams, n_pts, noise):
    """tests/conftest.make_synthetic_scene in numpy alone (so that the
    ``cuda`` test needs no JAX): points in front of a camera ring."""
    pts = rng.uniform(-1.0, 1.0, size=(n_pts, 3))
    pts[:, 2] += 5.0
    poses = []
    for i in range(n_cams):
        w = rng.normal(scale=0.1, size=3)
        t = np.array([0.5 * (i - n_cams / 2), 0.05 * i, 0.1 * i])
        poses.append(_exp_se3_np(np.concatenate([w, t])))
    poses = np.stack(poses)
    intr = np.array([600.0, 600.0, 320.0, 240.0])
    uv = np.zeros((n_cams, n_pts, 2))
    for c in range(n_cams):
        pc = pts @ poses[c, :3, :3].T + poses[c, :3, 3]
        uv[c, :, 0] = intr[0] * pc[:, 0] / pc[:, 2] + intr[2]
        uv[c, :, 1] = intr[1] * pc[:, 1] / pc[:, 2] + intr[3]
    if noise > 0:
        uv += rng.normal(scale=noise, size=uv.shape)
    return poses, pts, intr, uv


def _exp_se3_np(xi):
    return tba.exp_se3(torch.as_tensor(xi, dtype=torch.float64)).numpy()


def make_problem(seed=0, n_cams=8, n_pts=150, noise=0.5, pose_noise=0.05, pt_noise=0.05,
                 n_fixed=2, drop=0.1, anchors=False):
    """The problem of tests/test_ba.py as a dict of numpy arrays: noisy
    poses and points around a synthetic scene, the first cameras fixed, a
    tenth of the observations masked, one camera and a few landmarks out
    of the problem; with ``anchors`` every camera carries its ground-truth
    pose as an absolute reference (one row left unanchored, as zeros)."""
    rng = np.random.default_rng(seed)
    poses, pts, intr, uv = _scene_np(rng, n_cams, n_pts, noise)
    N, L = n_cams, n_pts
    obs_mask = rng.uniform(size=N * L) > drop
    poses_n = poses.copy()
    for i in range(n_fixed, N):
        xi = np.concatenate([rng.normal(scale=pose_noise, size=3),
                             rng.normal(scale=pose_noise * 2, size=3)])
        poses_n[i] = _exp_se3_np(xi) @ poses_n[i]
    cam_fixed = np.zeros(N, bool)
    cam_fixed[:n_fixed] = True
    cam_in_ba = np.ones(N, bool)
    cam_in_ba[N - 1] = False
    pt_in_ba = np.ones(L, bool)
    pt_in_ba[::17] = False
    d = dict(
        poses=poses_n.astype(np.float32),
        points=(pts + rng.normal(scale=pt_noise, size=pts.shape)).astype(np.float32),
        intr=intr.astype(np.float32),
        obs_cam=np.repeat(np.arange(N), L).astype(np.int32),
        obs_pt=np.tile(np.arange(L), N).astype(np.int32),
        obs_uv=uv.reshape(-1, 2).astype(np.float32),
        obs_mask=obs_mask, cam_in_ba=cam_in_ba, cam_fixed=cam_fixed, pt_in_ba=pt_in_ba,
        pt_obs_count=rng.integers(2, N + 1, size=L).astype(np.float32),
        abs_pose=None, abs_mask=None)
    if anchors:
        abs_pose = poses.astype(np.float32)
        abs_mask = np.ones(N, bool)
        abs_pose[3], abs_mask[3] = 0.0, False
        d.update(abs_pose=abs_pose, abs_mask=abs_mask, cam_fixed=np.zeros(N, bool))
    return d, poses


def _jax_problem(d):
    import jax.numpy as jnp
    from eacham_tpu.ba import BAProblem

    return BAProblem(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})


def test_problem_round_trip():
    d, _ = make_problem(anchors=True)
    p = convert.ba_problem_from_numpy(d, device="cpu")
    assert p.obs_cam.dtype == torch.int64 and p.obs_pt.dtype == torch.int64
    back = convert.ba_problem_to_numpy(p)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
    d2, _ = make_problem()
    p2 = convert.ba_problem_from_numpy(d2, device="cpu")
    assert p2.abs_pose is None and p2.abs_mask is None
    # carried from the reference's NamedTuple as well
    q = convert.ba_problem_from_numpy(_jax_problem(d2), device="cpu")
    for a, b in zip(q, p2):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("anchors", [False, True])
def test_ba_cost_matches_reference(anchors):
    """rel 1e-5, with and without the prior terms (anchored at perturbed
    states so that every prior contributes)."""
    import jax.numpy as jnp
    from eacham_tpu.ba import BAConfig as JConfig, ba_cost as jax_ba_cost

    d, _ = make_problem(anchors=anchors)
    p = convert.ba_problem_from_numpy(d, device="cpu")
    jp = _jax_problem(d)
    rng = np.random.default_rng(1)
    poses1 = np.stack([_exp_se3_np(rng.normal(scale=0.02, size=6)) @ T
                       for T in d["poses"]]).astype(np.float32)
    points1 = (d["points"] + rng.normal(scale=0.02, size=d["points"].shape)).astype(np.float32)
    intr1 = (d["intr"] + np.array([3.0, -2.0, 0.0, 0.0])).astype(np.float32)
    for with_priors in (False, True):
        ref = float(jax_ba_cost(jnp.asarray(poses1), jnp.asarray(points1), jnp.asarray(intr1),
                                jp, (jp.poses, jp.points, jp.intr) if with_priors else None,
                                JConfig()))
        got = float(tba.ba_cost(torch.as_tensor(poses1), torch.as_tensor(points1),
                                torch.as_tensor(intr1), p,
                                (p.poses, p.points, p.intr) if with_priors else None,
                                tba.BAConfig()))
        assert abs(got - ref) <= 1e-5 * abs(ref), (with_priors, got, ref)


CASES = [("dense", "lm", False), ("pcg", "lm", False), ("dense", "dogleg", False),
         ("pcg", "dogleg", False), ("dense", "lm", True), ("pcg", "lm", True),
         ("auto", "lm", False)]


@pytest.mark.parametrize("solver,method,anchors", CASES)
def test_refine_ba_matches_reference(solver, method, anchors):
    """Final cost rel 1e-3 and poses 1e-3 against the JAX package, for both
    solvers, both methods, with and without absolute anchors; cameras that
    are fixed or out of the problem do not move."""
    from eacham_tpu.ba import BAConfig as JConfig, refine_ba as jax_refine_ba

    d, _ = make_problem(anchors=anchors)
    kw = dict(max_iters=25, tolerance=1e-7, solver=solver, method=method,
              trust_radius_init=10.0, cg_iters=40)
    ref_poses, ref_points, ref_intr, ref_info = jax_refine_ba(_jax_problem(d), JConfig(**kw))
    poses, points, intr, info = tba.refine_ba(
        convert.ba_problem_from_numpy(d, device="cpu"), tba.BAConfig(**kw))
    c0, c1 = float(info["initial_cost"]), float(info["final_cost"])
    assert abs(c0 - float(ref_info["initial_cost"])) <= 1e-5 * c0
    assert c1 < 0.05 * c0
    assert abs(c1 - float(ref_info["final_cost"])) <= 1e-3 * float(ref_info["final_cost"])
    np.testing.assert_allclose(poses.numpy(), np.asarray(ref_poses), atol=1e-3)
    np.testing.assert_allclose(intr.numpy(), np.asarray(ref_intr), rtol=1e-3)
    on = d["pt_in_ba"]
    np.testing.assert_allclose(points.numpy()[on], np.asarray(ref_points)[on], atol=5e-3)
    still = d["cam_fixed"] | ~d["cam_in_ba"]
    np.testing.assert_array_equal(poses.numpy()[still], d["poses"][still])
    np.testing.assert_array_equal(points.numpy()[~on], d["points"][~on])
    assert 1 <= info["iterations"] <= 25


def test_cholesky_branch_and_its_guard():
    """dense_cg_iters=0 solves by Cholesky and agrees with the CG branch; a
    system that is not finite gives the zero step, not NaNs."""
    d, _ = make_problem()
    p = convert.ba_problem_from_numpy(d, device="cpu")
    out_cg = tba.refine_ba(p, tba.BAConfig(max_iters=15, solver="dense"))
    out_ch = tba.refine_ba(p, tba.BAConfig(max_iters=15, solver="dense", dense_cg_iters=0))
    assert abs(float(out_cg[3]["final_cost"]) - float(out_ch[3]["final_cost"])) \
        <= 1e-2 * float(out_cg[3]["final_cost"])
    bad = p._replace(obs_uv=torch.full_like(p.obs_uv, float("nan")))
    poses, points, _, _ = tba.refine_ba(
        bad, tba.BAConfig(max_iters=2, solver="dense", dense_cg_iters=0))
    assert torch.equal(poses, p.poses) and torch.equal(points, p.points)


def test_auto_solver_rule_is_the_reference_rule():
    """The same arithmetic on the same shapes: 20 cameras x 16384 landmarks
    fill the budget exactly and are dense, 21 x 16384 are not."""
    cfg = tba.BAConfig()

    def shaped(N, L):
        d, _ = make_problem(n_cams=2, n_pts=4)
        p = convert.ba_problem_from_numpy(d, device="cpu")
        return p._replace(poses=torch.zeros((N, 4, 4)), points=torch.zeros((L, 3)))

    assert tba.use_dense_solver(shaped(20, 16384), cfg)
    assert not tba.use_dense_solver(shaped(21, 16384), cfg)
    assert tba.use_dense_solver(shaped(100, 2048), cfg)
    assert not tba.use_dense_solver(shaped(100, 4096), cfg)
    assert not tba.use_dense_solver(shaped(100, 2048), cfg._replace(solver="pcg"))
    assert tba.use_dense_solver(shaped(100, 65536), cfg._replace(solver="dense"))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_cuda_refine_ba_matches_cpu(solver):
    """The card against the CPU on one problem: final cost rel 1e-3 (the
    card's segment sums are float atomics, so the last bits differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d, _ = make_problem()
    cfg = tba.BAConfig(max_iters=25, tolerance=1e-7, solver=solver, cg_iters=40)
    cpu = tba.refine_ba(convert.ba_problem_from_numpy(d, device="cpu"), cfg)
    gpu = tba.refine_ba(convert.ba_problem_from_numpy(d, device="cuda"), cfg)
    c_cpu, c_gpu = float(cpu[3]["final_cost"]), float(gpu[3]["final_cost"])
    assert abs(c_cpu - c_gpu) <= 1e-3 * c_cpu
    np.testing.assert_allclose(gpu[0].cpu().numpy(), cpu[0].numpy(), atol=1e-3)
