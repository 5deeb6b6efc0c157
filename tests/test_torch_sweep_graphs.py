"""The sweep's fixed-shape registration stages as CUDA graphs
(``eacham_tpu_torch.sfm.device_loop``): PnP, ``set_pose`` with the first
triangulation pass, and the second pass.

On the CPU: the sync-free forms of ``rt_to_mat``, ``gauss_newton_pose``,
``set_pose`` and ``alloc_landmarks`` against their earlier forms (copied
here) bit for bit; the stage entry points with the frame as a tensor against
``pnp_register`` / ``triangulate_frame`` with ints; ``run_sfm`` on the sweep
test's 12 frames, bit for bit before and after, and through the graph cache
(``eacham_tpu_torch.graphs``) with a capturer that reruns the stage into
fixed output buffers as a replay does; the dense BA's LM iteration, CG and
all (``ba.core._lm_iteration``), through the same cache. On a CUDA card
(``cuda``): the graphed sweep, its local and global BAs' iterations
replayed, against an eager one, a returned scene that a later request's
replays leave alone, a two-chunk stream that replays, and the graphed
dense BA against the eager one."""

from functools import partial

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eacham_tpu_torch import graphs
from eacham_tpu_torch.geometry import pnp, se3
from eacham_tpu_torch.geometry.ransac import draw_uniforms
from eacham_tpu_torch.sfm import device_loop, pipeline, scene as scene_mod, triangulate
from eacham_tpu_torch.sfm.pipeline import SfmOptions, initialize_sfm, next_best_view, run_sfm
from eacham_tpu_torch.sfm.scene import frame_pair_table
from eacham_tpu_torch.sfm.streaming import StreamingReconstructor
from eacham_tpu_torch.utils import timer
from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses, render_view

from test_torch_graphs import _rerun_into

torch.set_num_threads(2)

N_FRAMES, N_PTS, SIZE = 12, 160, (320, 240)
OPTS = dict(min_initial_inliers=40, min_matches=16, init_min_tri_angle_deg=0.5,
            min_tri_angle_deg=0.5, ransac_hyps_e=64, ransac_hyps_h=32, ransac_hyps_pnp=64,
            lm_capacity=1024, refine_max_iters=5, global_max_iters=12, local_ba_max_iters=4,
            local_ba_every=2)
STREAM_SIZE = (256, 192)
STREAM_OPTS = dict(max_features=128, min_initial_inliers=30, min_matches=12, match_ratio=0.85,
                   init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0, ransac_hyps_e=64,
                   ransac_hyps_h=32, ransac_hyps_pnp=64, lm_capacity=2048,
                   refine_max_iters=5, global_max_iters=8, local_ba_max_iters=3)
FIELDS = ("pose", "pose_valid", "points", "lm_valid", "n_landmarks", "kp2lm")


# ---- the earlier forms, as they were before the sweep's stages were graphed ----

def old_rt_to_mat(R, t):
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def old_gauss_newton_pose(T0, pts3d, uv, intr, weights, iters=10, damping=1e-6):
    T = T0
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    fx, fy = intr[0], intr[1]
    w = weights[..., None, None]
    for _ in range(iters):
        pc = se3.transform_points(T if T.dim() == 2 else T[..., None, :, :], pts3d)
        z = torch.clamp(pc[..., 2], min=1e-12)
        inv_z = 1.0 / z
        zeros = torch.zeros_like(z)
        du = torch.stack([fx * inv_z, zeros, -fx * pc[..., 0] * inv_z * inv_z], dim=-1)
        dv = torch.stack([zeros, fy * inv_z, -fy * pc[..., 1] * inv_z * inv_z], dim=-1)
        J_pc = torch.stack([du, dv], dim=-2)
        dpc = torch.cat([-se3.hat(pc), eye3.expand(pc.shape[:-1] + (3, 3))], dim=-1)
        J = J_pc @ dpc
        r = pnp.project_hom(pc, intr) - uv
        JtJ = torch.einsum("...nik,...nij->...kj", J * w, J)
        Jtr = torch.einsum("...nik,...ni->...k", J * w, r)
        dx = -torch.linalg.solve(JtJ + damping * eye6, Jtr)
        T = se3.exp_se3(dx) @ T
    return T


def old_set_pose(scene, frame, T):
    pose = scene.pose.clone()
    pose[frame] = T
    pose_valid = scene.pose_valid.clone()
    pose_valid[frame] = True
    return scene._replace(pose=pose, pose_valid=pose_valid)


def old_alloc_landmarks(scene, new_points, new_ok):
    offs = torch.cumsum(new_ok.to(torch.int32), 0, dtype=torch.int32) - 1
    ids = scene.n_landmarks + offs
    ok = new_ok & (ids < scene.lm_capacity)
    ids = torch.where(ok, ids, -1)
    L = scene.lm_capacity
    dst = torch.where(ok, ids, L).long()
    points = torch.cat([scene.points, scene.points.new_zeros((1, 3))])
    points[dst] = new_points.to(points.dtype)
    lm_valid = torch.cat([scene.lm_valid, scene.lm_valid.new_zeros(1)])
    lm_valid[dst] = True
    return scene._replace(points=points[:L], lm_valid=lm_valid[:L],
                          n_landmarks=scene.n_landmarks + ok.sum().to(torch.int32)), ids


def _old_forms(mp):
    """Every module that calls the four functions gets its earlier form."""
    for mod in (se3, pnp):
        mp.setattr(mod, "rt_to_mat", old_rt_to_mat)
    from eacham_tpu_torch.geometry import epipolar
    from eacham_tpu_torch.sfm import twoview
    for mod in (epipolar, twoview):
        mp.setattr(mod, "rt_to_mat", old_rt_to_mat)
    mp.setattr(pnp, "gauss_newton_pose", old_gauss_newton_pose)
    for mod in (pipeline, device_loop):
        mp.setattr(mod, "set_pose", old_set_pose)
    for mod in (scene_mod, triangulate, pipeline):
        mp.setattr(mod, "alloc_landmarks", old_alloc_landmarks)


# ---- inputs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracks():
    """tests/test_torch_sweep.py's sequence: exact tracks made with numpy."""
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
    return uv, dsc, vis, intr


@pytest.fixture(scope="module")
def frames():
    """Eight rendered frames for a stream of two chunks of four."""
    rng = np.random.default_rng(7)
    W, H = STREAM_SIZE
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = make_blob_scene(rng, n_blobs=500, depth=(3.0, 8.0), spread=2.2)
    poses = orbit_poses(8, radius=1.0, step_deg=2.5, advance=0.12)
    return np.stack([render_view(blobs, T, intr, W, H) for T in poses]), intr


def _sfm(tracks, device="cpu", seed=0):
    uv, dsc, vis, intr = tracks
    return run_sfm(uv, dsc, vis, SIZE, intr=intr, options=SfmOptions(seed=seed, **OPTS),
                   device=device)


def _stream(frames, device="cpu"):
    images, intr = frames
    rec = StreamingReconstructor(STREAM_SIZE, intr=intr, options=SfmOptions(**STREAM_OPTS),
                                 max_frames=8, window=3, retrieval_k=1, finalize_every=2,
                                 device=device)
    for c in range(2):
        rec.process(images[4 * c:4 * (c + 1)])
    return rec.scene


def _fields(scene):
    return {f: getattr(scene, f).clone() for f in FIELDS}


def _assert_equal(a, b):
    for f in FIELDS:
        assert torch.equal(a[f], b[f]), f


@pytest.fixture(scope="module")
def midway(tracks):
    """A scene three registrations into the sweep, its frame pair table,
    and the next view (prev, cur)."""
    uv, dsc, vis, intr = tracks
    opt = SfmOptions(**OPTS)
    scene, _ = initialize_sfm(uv, dsc, vis, SIZE, intr=intr, options=opt, device="cpu")
    fp = torch.as_tensor(frame_pair_table(scene.pair_idx.numpy(), N_FRAMES))
    gen = torch.Generator().manual_seed(3)
    excluded = torch.zeros(N_FRAMES, dtype=torch.bool)
    scene, excluded, n_reg, _ = device_loop.registration_sweep_step(
        scene, excluded, fp, gen, opt.max_repr_error, opt.min_tri_angle,
        n_hyp_pnp=64, ba_every=2, max_steps=3)
    assert n_reg == 3
    prev, cur, score = (int(v) for v in next_best_view(scene, excluded))
    assert score >= 0
    return scene, fp, prev, cur, opt


# ---- the sync-free forms --------------------------------------------------------

@pytest.mark.parametrize("batch", [(), (7,), (3, 5)])
def test_rt_to_mat_keeps_its_bits(batch):
    g = torch.Generator().manual_seed(len(batch))
    R = torch.randn(batch + (3, 3), generator=g)
    t = torch.randn(batch + (3,), generator=g)
    assert torch.equal(se3.rt_to_mat(R, t), old_rt_to_mat(R, t))
    xi = torch.randn(batch + (6,), generator=g)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(se3, "rt_to_mat", old_rt_to_mat)
        old = se3.exp_se3(xi), se3.inverse_se3(old_rt_to_mat(R, t))
    assert torch.equal(se3.exp_se3(xi), old[0])
    assert torch.equal(se3.inverse_se3(se3.rt_to_mat(R, t)), old[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gauss_newton_pose_keeps_its_bits(seed):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((96, 3), generator=g) * 2 - 1
    pts[:, 2] += 5.0
    intr = torch.tensor([400.0, 400.0, 160.0, 120.0])
    T = se3.exp_se3(torch.randn(6, generator=g) * 0.05)
    uv = pnp.project_hom(se3.transform_points(T, pts), intr)
    uv = uv + torch.randn(uv.shape, generator=g) * 0.5
    T0 = se3.exp_se3(torch.randn(6, generator=g) * 0.02) @ T
    w = (torch.rand(96, generator=g) > 0.2).float()
    new = pnp.gauss_newton_pose(T0, pts, uv, intr, w)
    assert torch.equal(new, old_gauss_newton_pose(T0, pts, uv, intr, w))
    # batched problems too (the loop-closing measurements' form)
    Tb = torch.stack([T0, T])
    wb = torch.stack([w, 1 - w])
    assert torch.equal(pnp.gauss_newton_pose(Tb, pts, uv, intr, wb),
                       old_gauss_newton_pose(Tb, pts, uv, intr, wb))


def test_set_pose_and_alloc_landmarks_keep_their_bits(midway):
    scene, _, _, cur, _ = midway
    g = torch.Generator().manual_seed(5)
    T = se3.exp_se3(torch.randn(6, generator=g))
    old = old_set_pose(scene, cur, T)
    for frame in (cur, torch.tensor([cur]), torch.tensor(cur)):
        new = pipeline.set_pose(scene, frame, T)
        assert torch.equal(new.pose, old.pose) and torch.equal(new.pose_valid, old.pose_valid)
    K = scene.kp_mask.shape[1]
    pts = torch.randn((K, 3), generator=g)
    for p in (0.0, 0.5, 1.0):
        ok = torch.rand(K, generator=g) < p
        new_scene, new_ids = scene_mod.alloc_landmarks(scene, pts, ok)
        old_scene, old_ids = old_alloc_landmarks(scene, pts, ok)
        assert torch.equal(new_ids, old_ids)
        for f in ("points", "lm_valid", "n_landmarks"):
            assert torch.equal(getattr(new_scene, f), getattr(old_scene, f)), f
    # past the capacity: the ids that do not fit are refused alike
    full = scene._replace(n_landmarks=torch.tensor(scene.lm_capacity - 5, dtype=torch.int32))
    ok = torch.ones(K, dtype=torch.bool)
    assert torch.equal(scene_mod.alloc_landmarks(full, pts, ok)[0].lm_valid,
                       old_alloc_landmarks(full, pts, ok)[0].lm_valid)


def test_run_sfm_keeps_its_bits(tracks):
    new = _fields(_sfm(tracks)[0])
    with pytest.MonkeyPatch.context() as mp:
        _old_forms(mp)
        old_scene, stats = _sfm(tracks)
    assert stats["registered"] == N_FRAMES
    _assert_equal(new, _fields(old_scene))


# ---- the stage entry points ------------------------------------------------------

@pytest.mark.parametrize("pair_only", [False, True])
def test_pnp_stage_with_tensor_frames_is_pnp_register(midway, pair_only):
    scene, fp, prev, cur, _ = midway
    K = scene.kp_mask.shape[1]
    T, n = pipeline.pnp_register(scene, prev, cur, fp[cur], torch.Generator().manual_seed(9),
                                 n_hyp=64, pair_only=pair_only)
    u = draw_uniforms(torch.Generator().manual_seed(9), (), 64, K, "cpu")
    out = device_loop.pnp_stage(
        {**scene._asdict(), "prev": torch.tensor([prev]), "cur": torch.tensor([cur]),
         "pair_rows": fp[cur], "u": u}, n_hyp=64, pair_only=pair_only)
    assert torch.equal(out["T"], T) and torch.equal(out["n_inl"], n)
    assert int(n) >= 15


@pytest.mark.parametrize("min_observers", [2, 3])
def test_triangulate_stage_with_tensor_frames_is_triangulate_frame(midway, min_observers):
    scene, fp, _, cur, opt = midway
    tri = dict(max_repr_error=opt.max_repr_error, min_tri_angle=opt.min_tri_angle,
               max_observers=opt.max_observers)
    T = scene.pose[cur - 1]
    posed = min_observers == 2
    ref = pipeline.set_pose(scene, cur, T) if posed else scene
    ref, _, n_new = triangulate.triangulate_frame(ref, cur, fp[cur], min_observers, **tri)
    t = {**scene._asdict(), "cur": torch.tensor([cur]), "pair_rows": fp[cur]}
    if posed:
        t["T"] = T
    out = device_loop.triangulate_stage(t, min_observers=min_observers, **tri)
    assert set(out) == set(FIELDS if posed else FIELDS[2:])
    for f, v in out.items():
        assert torch.equal(v, getattr(ref, f)), f
    assert int(n_new) > 0


# ---- through the cache ------------------------------------------------------------

def test_run_sfm_through_the_cache_keeps_its_bits(tracks, monkeypatch):
    eager = [_fields(_sfm(tracks, seed=s)[0]) for s in (0, 1)]
    monkeypatch.setattr(graphs, "graphable", lambda dev: True)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(
        capture=partial(graphs.StageGraph, record=_rerun_into)))
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first, stats = _sfm(tracks, seed=0)
    recs = list(timer.records())
    timer.clear()
    kept = _fields(first)
    second, _ = _sfm(tracks, seed=1)
    assert stats["registered"] == N_FRAMES
    _assert_equal(_fields(first), eager[0])
    _assert_equal(_fields(second), eager[1])
    _assert_equal(_fields(first), kept)        # the second request left the first's scene
    stages = [r for r in recs if r["name"] in ("sfm.device_loop.pnp",
                                               "sfm.device_loop.triangulate")]
    replays = sum(r["counts"].get("graph_replays", 0) for r in stages)
    captures = sum(r["counts"].get("graph_captures", 0) for r in stages)
    # three keys: each eager once, captured once, replayed on the other frames
    assert captures == 3 and replays == len(stages) - 6
    assert _lm_replays(recs) > 0


def _dense_ba(method, device="cpu"):
    """``refine_ba`` on the BA tests' problem through the dense solver's CG,
    under a span; returns (poses, points, intr, info) and the span's graph
    counts."""
    import importlib.util
    from pathlib import Path

    from eacham_tpu_torch import convert
    from eacham_tpu_torch.ba import core as tba

    # by path: a machine may have another top-level ``tests`` package installed
    spec = importlib.util.spec_from_file_location(
        "torch_ba_tests", Path(__file__).with_name("test_torch_ba.py"))
    ba_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ba_tests)
    d, _ = ba_tests.make_problem()
    p = convert.ba_problem_from_numpy(d, device=device)
    cfg = tba.BAConfig(max_iters=12, tolerance=1e-9, solver="dense", method=method)
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("ba"):
            out = tba.refine_ba(p, cfg)
    (rec,) = [r for r in timer.records() if r["name"] == "ba"]
    timer.clear()
    return out, {k: v for k, v in rec["counts"].items() if "graph_" in k}


def _assert_same_ba(a, b):
    assert a[3]["iterations"] == b[3]["iterations"]
    for x, y in zip(a[:3] + (a[3]["final_cost"],), b[:3] + (b[3]["final_cost"],)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["lm", "dogleg"])
def test_dense_ba_cg_through_the_cache_keeps_its_bits(method, monkeypatch):
    """The dense solver's fixed-step CG runs inside the LM iteration, which
    is one key of the cache: eager on its first iteration, captured on its
    second, replayed after; the result is the eager run's, bit for bit."""
    eager, counts = _dense_ba(method)
    assert counts == {}          # the CPU: eager throughout
    monkeypatch.setattr(graphs, "graphable", lambda dev: True)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(
        capture=partial(graphs.StageGraph, record=_rerun_into)))
    graphed, counts = _dense_ba(method)
    assert eager[3]["iterations"] >= 3
    _assert_same_ba(graphed, eager)
    assert counts == {"lm_graph_captures": 1,
                      "lm_graph_replays": eager[3]["iterations"] - 2}


# ---- on the card --------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _counts(recs, name):
    return sum(r["counts"].get(name, 0) for r in recs
               if r["name"] in ("sfm.device_loop.pnp", "sfm.device_loop.triangulate"))


def _lm_replays(recs):
    """LM iterations replayed in the local and the global BAs."""
    return sum(r["counts"].get("lm_graph_replays", 0) for r in recs
               if r["name"] in ("sfm.device_loop.local_ba", "ba.global"))


@pytest.mark.cuda
def test_graphed_sweep_is_the_eager_sweep_on_the_card(tracks, monkeypatch):
    _card()
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(size=0))
    eager = [_fields(_sfm(tracks, "cuda", seed=s)[0]) for s in (0, 1)]
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first, stats = _sfm(tracks, "cuda", seed=0)
        kept = _fields(first)
        second, _ = _sfm(tracks, "cuda", seed=1)
    recs = list(timer.records())
    timer.clear()
    assert stats["registered"] == N_FRAMES
    assert _counts(recs, "graph_captures") == 3 and _counts(recs, "graph_replays") > 0
    assert _lm_replays(recs) > 0
    _assert_equal(_fields(first), eager[0])
    _assert_equal(_fields(second), eager[1])
    # request 2 replayed the graphs request 1 captured: request 1's scene is untouched
    _assert_equal(_fields(first), kept)


@pytest.mark.cuda
def test_a_two_chunk_stream_replays_on_the_card(frames, monkeypatch):
    _card()
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(size=0))
    eager = _fields(_stream(frames, "cuda"))
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        graphed = _fields(_stream(frames, "cuda"))
    recs = list(timer.records())
    timer.clear()
    assert _counts(recs, "graph_replays") > 0 and _lm_replays(recs) > 0
    _assert_equal(graphed, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lm", "dogleg"])
def test_dense_ba_cg_graph_is_the_eager_solve_on_the_card(method, monkeypatch):
    _card()
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(size=0))
    eager, _ = _dense_ba(method, "cuda")
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    graphed, counts = _dense_ba(method, "cuda")
    assert counts == {"lm_graph_captures": 1,
                      "lm_graph_replays": eager[3]["iterations"] - 2}
    _assert_same_ba(graphed, eager)


# ---- the benchmark's reader ----------------------------------------------------------

def _reader():
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "sfmbench" / "metrics"
            / "sweep_graph_share.batch.py")
    spec = importlib.util.spec_from_file_location("sweep_graph_share_batch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_benchmark_reads_the_share_of_replayed_stages(monkeypatch):
    from sfmbench import spans

    reader = _reader()

    def rec(name, parent, root, counts):
        return {"name": name, "start_ns": 0, "end_ns": 1, "parent": parent, "root": root,
                "attrs": {}, "counts": counts}

    def records(counted):
        # an earlier request's spans (root 0) are not read
        out = [rec("sfm.pipeline.run_sfm", None, 0, {}),
               rec("sfm.device_loop.pnp", 0, 0, {"graph_replays": 1}),
               rec("sfm.pipeline.run_sfm", None, 1, {}), rec("sfm.device_loop", 2, 1, {})]
        kinds = ["graph_captures"] + ["graph_replays"] * 6 + [None]
        for i, kind in enumerate(kinds):
            name = "sfm.device_loop.pnp" if i % 3 == 0 else "sfm.device_loop.triangulate"
            out.append(rec(name, 3, 1, {kind: 1} if counted and kind else {}))
        return out

    ctx = {"traced_request": {"registered": 3}}
    monkeypatch.setattr(spans, "records", lambda: records(True))
    assert reader.read(ctx) == pytest.approx(100.0 * 6 / 8)
    # a program that counts neither (no stage graphs): nothing to read
    monkeypatch.setattr(spans, "records", lambda: records(False))
    assert reader.read(ctx) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert reader.read(ctx) is None
    assert reader.read({"traced_request": None}) is None
