"""The port's map-building pieces against the JAX package on one seeded
mid-sweep scene, made with numpy and carried to both (CPU): the BA-problem
functions of ``sfm/scene.py``, ``next_best_view``, ``local_neighbors`` and
``pnp_register`` of ``sfm/pipeline.py``, ``sfm/triangulate.triangulate_frame``
and ``sfm/filtering.prune_observations``.

Index arrays and masks must be equal; points agree to 1e-4. The scene is
built to have the ties that the two libraries could break differently: more
window candidates than ``max_cams``, more observers than ``max_observers``,
several neighbours that qualify for a merge, and equal next-best-view
scores."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.sfm import filtering as jfil
from eacham_tpu.sfm import pipeline as jpipe
from eacham_tpu.sfm import scene as jscene
from eacham_tpu.sfm import triangulate as jtri
from eacham_tpu_torch import convert
from eacham_tpu_torch.sfm import filtering as tfil
from eacham_tpu_torch.sfm import pipeline as tpipe
from eacham_tpu_torch.sfm import scene as tscene
from eacham_tpu_torch.sfm import triangulate as ttri

torch.set_num_threads(2)

N, K, L, REGISTERED = 12, 96, 256, 9


def make_scene_np(seed=0, noise=0.3):
    """A 12-frame sideways-moving camera over 96 points, each frame seeing
    most of them as keypoints (slot k is point k, so matches are the
    identity with dropouts); all pairs, a few edges dead. The first 9
    frames are registered at their true poses; landmarks exist for two
    thirds of the points with 1 to 9 observers among frames 0-8, some
    flagged two-view, some slots stale or invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (K, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    f = 300.0
    intr = np.array([f, f, 160.0, 120.0], np.float32)
    Ts = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    for i in range(N):
        a = 0.03 * i
        c, s = np.cos(a), np.sin(a)
        Ts[i, :3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        Ts[i, :3, 3] = [0.2 * i, 0.01 * i, 0.02 * i]
    pc = np.einsum("nij,pj->npi", Ts[:, :3, :3], pts) + Ts[:, None, :3, 3]
    uv = np.stack([f * pc[..., 0] / pc[..., 2] + intr[2],
                   f * pc[..., 1] / pc[..., 2] + intr[3]], -1)
    uv = (uv + rng.normal(scale=noise, size=uv.shape)).astype(np.float32)
    kp_mask = rng.random((N, K)) > 0.1

    pair_idx = np.array([(i, j) for i in range(N) for j in range(i + 1, N)], np.int32)
    P = len(pair_idx)
    pair_ok = rng.random(P) > 0.15
    ident = np.broadcast_to(np.arange(K, dtype=np.int32), (P, K)).copy()
    valid = (rng.random((P, K)) > 0.25) & kp_mask[pair_idx[:, 0]] & kp_mask[pair_idx[:, 1]]
    valid &= pair_ok[:, None]
    # a few wrong matches: keypoints k and k+1 swapped, in both directions
    m_ij = ident.copy()
    for p in range(0, P, 5):
        k = 2 * (p % 40)
        m_ij[p, [k, k + 1]] = [k + 1, k]
    m_ji = m_ij.copy()          # a swap is its own inverse

    pose = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    pose[:REGISTERED] = Ts[:REGISTERED]
    pose_valid = np.arange(N) < REGISTERED
    pose_fixed = np.arange(N) == 0

    points = np.zeros((L, 3), np.float32)
    lm_valid = np.zeros(L, bool)
    lm_two_view = np.zeros(L, bool)
    kp2lm = np.full((N, K), -1, np.int32)
    n_lm = 0
    for k in range(K):
        if k % 3 == 2:
            continue                       # no landmark yet: left to triangulate
        n_obs = 1 + (k * 7 + 3) % REGISTERED
        frames = rng.choice(REGISTERED, size=n_obs, replace=False)
        points[n_lm] = pts[k] + rng.normal(scale=0.005, size=3)
        lm_valid[n_lm] = k % 11 != 5       # some invalidated landmarks with links left
        lm_two_view[n_lm] = k % 4 == 0
        kp2lm[frames, k] = n_lm
        n_lm += 1
    d = dict(keypoints=uv, kp_mask=kp_mask, pose=pose, pose_valid=pose_valid,
             pose_fixed=pose_fixed, pair_idx=pair_idx, pair_ok=pair_ok, match_ij=m_ij,
             valid_ij=valid, match_ji=m_ji, valid_ji=valid.copy(), points=points,
             lm_valid=lm_valid, lm_two_view=lm_two_view,
             n_landmarks=np.int32(n_lm), kp2lm=kp2lm, intr=intr)
    # valid_ji must be indexed by frame j's keypoint: permute the swapped slots
    vji = np.zeros_like(valid)
    np.put_along_axis(vji, m_ij.astype(np.int64), valid, axis=1)
    d["valid_ji"] = vji
    return d, Ts


def both(d):
    return (jscene.Scene(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.scene_from_numpy(d, device="cpu"))


def assert_scene_equal(ts, js, atol=1e-4):
    """Integer and boolean fields equal, landmark points ``atol`` where valid."""
    t, j = convert.scene_to_numpy(ts), {k: np.asarray(v) for k, v in js._asdict().items()}
    for k in ("kp2lm", "lm_valid", "lm_two_view", "pose_valid", "n_landmarks"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["points"][t["lm_valid"]], j["points"][j["lm_valid"]], atol=atol)
    np.testing.assert_allclose(t["pose"], j["pose"], atol=atol)


@pytest.fixture(scope="module")
def scenes():
    d, Ts = make_scene_np()
    js, ts = both(d)
    return d, Ts, js, ts


def test_observer_counts_and_problem_counts(scenes):
    d, _, js, ts = scenes
    np.testing.assert_array_equal(tscene.lm_observer_counts(ts).numpy(),
                                  np.asarray(jscene.lm_observer_counts(js)))
    for cams in (d["pose_valid"], np.arange(N) % 2 == 0):
        ref = jscene.ba_problem_counts(js, jnp.asarray(cams))
        out = tscene.ba_problem_counts(ts, torch.as_tensor(cams))
        assert (int(out[0]), int(out[1])) == (int(ref[0]), int(ref[1]))
        assert int(out[0]) > 50


@pytest.mark.parametrize("m", [1, 7, 40, 200])
def test_compact_mask(m):
    mask = np.random.default_rng(m).random(120) > 0.6
    ref = jscene._compact_mask(jnp.asarray(mask), m)
    out = tscene._compact_mask(torch.as_tensor(mask), m)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_problem_equal(out, ref):
    prob_t, *rest_t = out
    prob_j, *rest_j = ref
    for a, b in zip(rest_t, rest_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in prob_j._fields:
        a, b = getattr(prob_t, f), getattr(prob_j, f)
        if b is None:
            assert a is None
        elif np.asarray(b).dtype.kind == "f":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(max_cams=4, max_obs=16384, cur=7),                 # 9 candidates for 4 slots
    dict(max_cams=4, max_obs=16384, cur=None),
    dict(max_cams=6, max_obs=200, cur=8),                   # observation compaction
    dict(max_cams=6, max_obs=16384, cur=8, max_lms=20),     # landmark overflow
    dict(max_cams=8, max_obs=16384, cur=5, free_span=2),    # frozen elders
    dict(max_cams=N, max_obs=1024, max_lms=1024, cur=None),  # the global form
], ids=["tie-keeps-cur", "tie-no-cur", "max_obs", "max_lms", "free_span", "global"])
def test_ba_problem_windowed(scenes, kw):
    """Equal camera and landmark lists, masks and observation tables. With
    more registered candidates than ``max_cams`` the current frame is kept
    and the rest are the lowest indices, as the reference's top_k has it."""
    d, _, js, ts = scenes
    cams = d["pose_valid"]
    ref = jscene.ba_problem_windowed(js, jnp.asarray(cams), **kw)
    out = tscene.ba_problem_windowed(ts, torch.as_tensor(cams), **kw)
    _assert_problem_equal(out, ref)
    if kw.get("cur") == 7 and kw["max_cams"] == 4:
        assert out[1].tolist() == [7, 0, 1, 2]
    if kw.get("free_span"):
        assert bool(out[0].cam_fixed[out[1] < 3].all()) and not bool(out[0].cam_fixed.all())


def test_ba_problem_from_scene_and_scatter(scenes):
    d, _, js, ts = scenes
    cams = np.arange(N) < 6
    ref = jscene.ba_problem_from_scene(js, jnp.asarray(cams))
    out = tscene.ba_problem_from_scene(ts, torch.as_tensor(cams))
    _assert_problem_equal((out,), (ref,))
    prob, cam_list, cam_on, lm_list, lm_on = tscene.ba_problem_windowed(
        ts, torch.as_tensor(d["pose_valid"]), max_cams=4, max_obs=4 * K, cur=7, max_lms=128)
    s2 = tscene.scatter_window_poses(ts, cam_list, cam_on, prob.poses + 1.0)
    s2 = tscene.scatter_window_points(s2, lm_list, lm_on, prob.points + 1.0)
    moved = np.zeros(N, bool)
    moved[cam_list[cam_on].numpy()] = True
    np.testing.assert_allclose(s2.pose.numpy()[moved], d["pose"][moved] + 1.0)
    np.testing.assert_array_equal(s2.pose.numpy()[~moved], d["pose"][~moved])
    lm_moved = np.zeros(L, bool)
    lm_moved[lm_list[lm_on].numpy()] = True
    # slots that are off all carry index 0: landmark 0's own slot must win
    assert 20 < lm_moved.sum() < 128 and lm_moved[0] and int((~lm_on).sum()) > 0
    np.testing.assert_allclose(s2.points.numpy()[lm_moved], d["points"][lm_moved] + 1.0)
    np.testing.assert_array_equal(s2.points.numpy()[~lm_moved], d["points"][~lm_moved])


def test_next_best_view_and_local_neighbors(scenes):
    d, _, js, ts = scenes
    for excl in (np.zeros(N, bool), np.arange(N) == 9, np.arange(N) >= 9):
        ref = [int(v) for v in jpipe.next_best_view(js, jnp.asarray(excl))]
        out = [int(v) for v in tpipe.next_best_view(ts, torch.as_tensor(excl))]
        assert out[2] == ref[2]
        if ref[2] >= 0:
            assert out == ref
    assert int(tpipe.next_best_view(ts, torch.ones(N, dtype=torch.bool))[2]) < 0
    for cur in (3, 9, 11):
        np.testing.assert_array_equal(tpipe.local_neighbors(ts, cur).numpy(),
                                      np.asarray(jpipe.local_neighbors(js, cur)))


def test_next_best_view_takes_the_first_of_equal_scores():
    """Two unregistered frames with the same tables against the same
    registered frame score the same; the first edge in (forward rows,
    backward rows) order is taken, as the reference's argmax does."""
    d, _ = make_scene_np(1)
    rows = {tuple(p): r for r, p in enumerate(d["pair_idx"].tolist())}
    a, b = rows[(8, 9)], rows[(8, 10)]
    for k in ("pair_ok", "valid_ij", "valid_ji", "match_ij", "match_ji"):
        d[k][b] = d[k][a]
    d["pair_ok"][:] = False
    d["pair_ok"][[a, b]] = True
    d["valid_ij"] &= d["pair_ok"][:, None]
    d["valid_ji"] &= d["pair_ok"][:, None]
    js, ts = both(d)
    ref = [int(v) for v in jpipe.next_best_view(js, jnp.zeros(N, bool))]
    out = [int(v) for v in tpipe.next_best_view(ts, torch.zeros(N, dtype=torch.bool))]
    assert out == ref and out[:2] == [8, 9] and out[2] > 0


@pytest.mark.parametrize("min_observers,max_observers", [(2, 12), (3, 12), (2, 4)])
def test_triangulate_frame(scenes, min_observers, max_observers):
    """Frame 9 joins at its true pose: equal ``kp2lm``, ``lm_valid`` and
    counts, points 1e-4. With ``max_observers`` 4 every track has more
    observers than slots (nine registered neighbours), and keypoints with
    several qualifying neighbours must merge into the first one's landmark."""
    d, Ts, _, _ = scenes
    cur = REGISTERED
    d = dict(d, pose=d["pose"].copy(), pose_valid=d["pose_valid"].copy())
    d["pose"][cur] = Ts[cur]
    d["pose_valid"][cur] = True
    js, ts = both(d)
    fp = jscene.frame_pair_table(d["pair_idx"], N)
    ref = jtri.triangulate_frame(js, jnp.int32(cur), jnp.asarray(fp[cur]),
                                 jnp.int32(min_observers), 4.0, float(np.deg2rad(0.5)),
                                 max_observers=max_observers)
    out = ttri.triangulate_frame(ts, cur, torch.as_tensor(fp[cur]), min_observers, 4.0,
                                 float(np.deg2rad(0.5)), max_observers=max_observers)
    assert (int(out[1]), int(out[2])) == (int(ref[1]), int(ref[2]))
    assert int(out[1]) > 5 and int(out[2]) > 5
    assert_scene_equal(out[0], ref[0])


def test_scatter_last_wins_is_the_reference_order():
    """Several writers of one slot: the last in order wins, as the
    reference's scatter has it on the CPU (where its result is determined)."""
    target = np.array([3, 1, 3, 5, 1, 3, 6], np.int64)
    value = np.arange(10, 17, dtype=np.int32)
    ref = np.asarray(jnp.zeros(7, jnp.int32).at[jnp.asarray(target)].set(jnp.asarray(value)))
    dst = torch.zeros(7, dtype=torch.int32)
    ttri.scatter_last_wins(dst, torch.as_tensor(target), torch.as_tensor(value))
    np.testing.assert_array_equal(dst.numpy(), ref)
    assert dst.tolist() == [0, 14, 0, 15, 0, 13, 16]


def test_first_true_and_first_k_true():
    m = torch.tensor([[0, 1, 1, 0], [0, 0, 0, 0], [1, 0, 1, 1]]).bool()
    idx, has = ttri.first_true(m, 1)
    assert idx.tolist() == [1, 0, 0] and has.tolist() == [True, False, True]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp.argmax(jnp.asarray(m.numpy()), 1)))
    sel, on = ttri.first_k_true(m, 3)
    val, ref = jax.lax.top_k(jnp.asarray(m.numpy()).astype(jnp.int32), 3)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(on.numpy(), np.asarray(val) > 0)


def test_prune_observations(scenes):
    """Landmarks moved off (some behind the cameras) lose their
    observations, and those left with fewer than two observers die."""
    d, _, _, _ = scenes
    d = dict(d, points=d["points"].copy())
    d["points"][::5] += np.array([0.4, 0.0, 0.0], np.float32)
    d["points"][3::10, 2] -= 8.0
    js, ts = both(d)
    ref = jfil.prune_observations(js, 6.0)
    out = tfil.prune_observations(ts, 6.0)
    assert (int(out[1]), int(out[2])) == (int(ref[1]), int(ref[2]))
    assert int(out[1]) > 20 and int(out[2]) > 3
    assert_scene_equal(out[0], ref[0])


def test_pnp_register_recovers_the_new_frames_pose(scenes):
    """Each package with its own draws: both register frame 9 within 2e-2
    of its true pose on the scene's landmarks, with inlier counts within 5
    of each other; ``pair_only`` uses one neighbour's matches alone."""
    d, Ts, js, ts = scenes
    cur = REGISTERED
    rows = {tuple(p): r for r, p in enumerate(d["pair_idx"].tolist())}
    prev = next(i for i in range(REGISTERED - 1, -1, -1) if d["pair_ok"][rows[(i, cur)]])
    fp = jscene.frame_pair_table(d["pair_idx"], N)
    T_ref, n_ref = jpipe.pnp_register(js, jnp.int32(prev), jnp.int32(cur), jnp.asarray(fp[cur]),
                                      jax.random.PRNGKey(0), n_hyp=64)
    g = torch.Generator().manual_seed(0)
    T, n = tpipe.pnp_register(ts, prev, cur, torch.as_tensor(fp[cur]), g, n_hyp=64)
    np.testing.assert_allclose(T.numpy(), Ts[cur], atol=2e-2)
    np.testing.assert_allclose(np.asarray(T_ref), Ts[cur], atol=2e-2)
    assert abs(int(n) - int(n_ref)) <= 5 and int(n) > 30
    _, n_pair = tpipe.pnp_register(ts, prev, cur, torch.as_tensor(fp[cur]), g, n_hyp=64,
                                   pair_only=True)
    assert 6 <= int(n_pair) < int(n)
