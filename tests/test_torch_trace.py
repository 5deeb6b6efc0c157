"""The port's spans and counters (``eacham_tpu_torch.utils.timer``) on the
CPU: recorded exactly while a torch profiler runs, on the profiler's clock,
in the reconstruction path's nesting, with the local BA's LM iterations and
the host's waits for the card counted, and without a change to any result;
the profiling script's split of the spans and of the card's idle time; and,
on a CUDA card, the count of host waits against the synchronizations that
``torch.cuda.set_sync_debug_mode("warn")`` flags.

The inputs are exact tracks made with numpy (12 frames, 160 points, as
tests/test_torch_sweep.py's) and, for the streaming reconstructor, 8
rendered frames in two chunks of 4."""

import importlib.util
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from eacham_tpu_torch.sfm import device_loop
from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
from eacham_tpu_torch.sfm.streaming import StreamingReconstructor
from eacham_tpu_torch.utils import timer
from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses, render_view

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


@pytest.fixture(scope="module")
def tracks():
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
    rng = np.random.default_rng(7)
    W, H = STREAM_SIZE
    f = 1.2 * max(W, H)
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    blobs = make_blob_scene(rng, n_blobs=500, depth=(3.0, 8.0), spread=2.2)
    poses = orbit_poses(8, radius=1.0, step_deg=2.5, advance=0.12)
    return np.stack([render_view(blobs, T, intr, W, H) for T in poses]), intr


def _sfm(tracks):
    uv, dsc, vis, intr = tracks
    return run_sfm(uv, dsc, vis, SIZE, intr=intr, options=SfmOptions(**OPTS), device="cpu")


def _stream(frames):
    images, intr = frames
    rec = StreamingReconstructor(STREAM_SIZE, intr=intr, options=SfmOptions(**STREAM_OPTS),
                                 max_frames=8, window=3, retrieval_k=1, finalize_every=2,
                                 device="cpu")
    for c in range(2):
        rec.process(images[4 * c:4 * (c + 1)])
    return rec.scene


def _never(*a, **k):
    raise AssertionError("record_function entered with no profiler running")


@pytest.fixture(scope="module")
def plain(tracks, frames):
    """Both paths with no profiler running and ``record_function`` made to
    raise."""
    timer.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autograd_profiler, "record_function", _never)
        scene, stats = _sfm(tracks)
        recorded = list(timer.records())
        stream = _stream(frames)
    return scene, stats, recorded + list(timer.records()), stream


@pytest.fixture(scope="module")
def traced(tracks, frames):
    """Both paths under ``torch.profiler``, the local BAs' infos kept."""
    infos = []
    refine_ba = device_loop.refine_ba

    def kept(*a, **k):
        out = refine_ba(*a, **k)
        infos.append(out[3])
        return out

    timer.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_loop, "refine_ba", kept)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            scene, stats = _sfm(tracks)
            stream = _stream(frames)
    recs = list(timer.records())
    timer.clear()
    events = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return scene, stats, recs, stream, infos, events


def test_no_profiler_no_records(plain):
    _, stats, recorded, _ = plain
    assert stats["registered"] == N_FRAMES
    assert recorded == []


def test_the_span_tree(traced):
    _, stats, recs, _, infos, _ = traced
    root = recs.index(next(r for r in recs if r["name"] == "sfm.pipeline.run_sfm"))
    mine = [r for r in recs if r["root"] == recs[root]["root"]]
    names = Counter(r["name"] for r in mine)
    sweep = recs.index(next(r for r in mine if r["name"] == "sfm.device_loop"))

    def parent(r):
        return recs[r["parent"]]["name"] if r["parent"] is not None else None

    assert recs[root]["parent"] is None
    for name in ("sfm.matches", "sfm.pipeline.init_pair", "sfm.device_loop",
                 "sfm.pipeline._finalize"):
        hits = [r for r in mine if r["name"] == name]
        assert len(hits) == 1 and hits[0]["parent"] == root, name
    for name in ("next_view", "pnp", "triangulate", "local_ba"):
        rows = [r for r in mine if r["name"] == f"sfm.device_loop.{name}"]
        assert rows and all(r["parent"] == sweep for r in rows), name
    assert names["sfm.device_loop.triangulate"] == 2 * (N_FRAMES - 2)
    assert parent(next(r for r in mine if r["name"] == "ba.global")) == "sfm.pipeline._finalize"
    assert parent(next(r for r in mine if r["name"] == "sfm.pipeline.seed")) == \
        "sfm.pipeline.init_pair"
    assert recs[sweep]["counts"]["registered"] == N_FRAMES - 2
    # the local BAs' LM iterations, one count a BA that ran (run_sfm's come first)
    ran = [r["counts"]["iterations"] for r in mine
           if r["name"] == "sfm.device_loop.local_ba" and "iterations" in r["counts"]]
    assert ran and ran == [info["iterations"] for info in infos[:len(ran)]]
    assert stats["local_ba"] == {"calls": len(ran), "iterations": sum(ran)}
    # the stream: one root a call, tagged with its reconstructor, its stages inside
    calls = [i for i, r in enumerate(recs) if r["name"] == "sfm.streaming.process"]
    assert len(calls) == 2 and all(recs[i]["parent"] is None for i in calls)
    assert len({recs[i]["attrs"]["stream"] for i in calls}) == 1
    assert len({recs[i]["root"] for i in calls}) == 2
    for stage in ("extract", "pairs", "match", "resume"):
        rows = [r for r in recs if r["name"] == f"sfm.streaming.process.{stage}"]
        assert rows and all(r["parent"] in calls for r in rows), stage
    resumes = [i for i, r in enumerate(recs) if r["name"] == "sfm.pipeline.resume_sfm"]
    assert resumes and all(recs[recs[i]["parent"]]["name"] == "sfm.streaming.process.resume"
                           for i in resumes)
    # every 2nd chunk finalizes: its global BA sits in its resume
    assert any(parent(r) == "sfm.pipeline._finalize" and r["root"] == recs[calls[1]]["root"]
               for r in recs if r["name"] == "ba.global")


def test_spans_share_the_profilers_clock(traced):
    recs, events = traced[2], traced[5]
    starts = {}
    for e in events:
        starts.setdefault(e.name(), []).append(e.start_ns())
    mine = {}
    for r in recs:
        mine.setdefault(r["name"], []).append(r["start_ns"])
    assert set(mine) <= set(starts)
    for name, xs in mine.items():
        assert len(xs) == len(starts[name]), name
        for a, b in zip(sorted(xs), sorted(starts[name])):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_results_are_bit_equal_with_and_without_the_profiler(plain, traced):
    for a, b in ((plain[0], traced[0]), (plain[3], traced[3])):
        for f in ("pose", "pose_valid", "points", "lm_valid", "kp2lm"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert plain[1]["local_ba"] == traced[1]["local_ba"]


def test_readback_counts_one_a_call():
    timer.clear()
    x = torch.arange(3)
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("outer") as outer:
            assert timer.readback(torch.Tensor.tolist, x) == [0, 1, 2]
            with timer.span("inner"):
                assert timer.readback(int, x.sum()) == 3
                assert timer.readback(bool, x.any()) is True
            outer.add("frames", 2)
    outer_rec, inner_rec = timer.records()
    timer.clear()
    assert outer_rec["counts"] == {"readbacks": 1, "frames": 2}
    assert inner_rec["counts"] == {"readbacks": 2}
    assert timer.readback(int, x.sum()) == 3 and timer.records() == []


def test_a_new_profiler_session_drops_the_old_records():
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("first"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("second"):
            pass
    # no span ran between the two sessions: both kept, each its own root
    kept = timer.records()
    assert [r["name"] for r in kept] == ["first", "second"] and kept[0]["root"] != kept[1]["root"]
    with timer.span("unprofiled"):
        pass
    assert len(timer.records()) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("third"):
            with timer.span("inner"):
                pass
        with timer.span("fourth"):
            pass
    got = [(r["name"], r["parent"]) for r in timer.records()]
    timer.clear()
    assert got == [("third", None), ("inner", 0), ("fourth", None)]


def _profile_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "profile_slice_torch.py"
    spec = importlib.util.spec_from_file_location("profile_slice_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_script_splits_spans_and_idle_time():
    script = _profile_script()
    recs = [
        {"name": "root", "start_ns": 0, "end_ns": 100, "parent": None, "root": 0,
         "attrs": {}, "counts": {"registered": 2}},
        {"name": "a", "start_ns": 10, "end_ns": 40, "parent": 0, "root": 0, "attrs": {},
         "counts": {"readbacks": 3}},
        {"name": "b", "start_ns": 50, "end_ns": 60, "parent": 0, "root": 0, "attrs": {},
         "counts": {"readbacks": 1, "iterations": 4}},
        {"name": "a", "start_ns": 200, "end_ns": 300, "parent": None, "root": 1, "attrs": {},
         "counts": {}},
        {"name": "open", "start_ns": 400, "end_ns": None, "parent": None, "root": 2,
         "attrs": {}, "counts": {}},
    ]
    rows = script.span_rows(recs)
    assert set(rows) == {"root", "a", "b"}
    assert rows["root"]["self"] == pytest.approx(60e-9)
    assert rows["a"]["calls"] == 2 and rows["a"]["seconds"] == pytest.approx(130e-9)
    assert rows["b"]["counts"] == {"readbacks": 1, "iterations": 4}
    assert script.union([(45, 55), (0, 12), (50, 60)]) == [[0, 12], [45, 60]]
    # busy 0-12, 45-55 and 100-105: gaps 12-45 (midpoint 28.5, in a), 55-100 (77.5, in
    # root alone) and 105-110 (outside every span)
    idle = script.idle_by_span(recs, [(0, 12), (45, 55), (100, 105)], 0, 110)
    assert idle == pytest.approx({"a": 33e-9, "root": 45e-9, None: 5e-9})


@pytest.mark.cuda
def test_host_waits_are_the_syncs_of_the_sweep(tracks):
    """On the card, under ``set_sync_debug_mode("warn")``: the synchronizations
    flagged while ``sfm.device_loop`` is open, by the innermost span open at
    each, equal the count ``readbacks`` of the sweep's spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    uv, dsc, vis, intr = tracks

    def sfm():
        return run_sfm(uv, dsc, vis, SIZE, intr=intr, options=SfmOptions(**OPTS),
                       device="cuda")

    sfm()
    flagged = []

    def seen(message, *a, **k):
        if "synchronizing" in str(message):
            recs = timer.records()
            inner = [i for i, r in enumerate(recs) if r["end_ns"] is None]
            flagged.append(inner[-1] if inner else None)

    timer.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, stats = sfm()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    recs = list(timer.records())
    timer.clear()
    sweep = next(i for i, r in enumerate(recs) if r["name"] == "sfm.device_loop")

    def in_sweep(i):
        while i is not None and i != sweep:
            i = recs[i]["parent"]
        return i == sweep

    syncs = Counter(recs[i]["name"] for i in flagged if in_sweep(i))
    waits = Counter()
    for i, r in enumerate(recs):
        if in_sweep(i) and r["counts"].get("readbacks"):
            waits[r["name"]] += r["counts"]["readbacks"]
    assert stats["registered"] == N_FRAMES
    assert sum(syncs.values()) > 0
    assert sum(syncs.values()) == sum(waits.values()), (syncs, waits)
    assert syncs == waits
