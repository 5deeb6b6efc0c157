"""The BA's LM iteration as one CUDA graph (``eacham_tpu_torch.ba.core``:
``_lm_iteration`` through ``graphs.staged``) and the fixed-shape layout that
lets every problem of one size share its graph.

On the CPU: the fixed-shape ``_layout`` against its earlier form (copied
here, the landmark order cut to the live rows) sum for sum, bit for bit,
with masked rows, in equal runs and in slots; ``refine_ba`` through the
graph cache with a capturer that reruns the iteration into fixed output
buffers, as a replay does, against the eager run (LM and dogleg, dense CG
and Cholesky); two problems with different live observations on one key;
the PCG solver and a process group, which never reach the cache; the dense
CG's plain-tensor form against its earlier dict form. On a CUDA card (``cuda``; no JAX is imported here): the graphed
``refine_ba`` against the eager one, bit for bit, and a replayed iteration
that waits for the card nowhere:

    python -m pytest --noconftest -m cuda tests/test_torch_ba_graphs.py
"""

import importlib.util
from functools import partial
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from eacham_tpu_torch import convert, graphs
from eacham_tpu_torch.ba import core as tba
from eacham_tpu_torch.utils import timer

from test_torch_graphs import _rerun_into

torch.set_num_threads(2)


def _ba_tests():
    # by path: a machine may have another top-level ``tests`` package installed
    spec = importlib.util.spec_from_file_location(
        "torch_ba_tests", Path(__file__).with_name("test_torch_ba.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _problem(seed=0, shuffle=False, drop=0.1, device="cpu"):
    """The BA tests' problem (8 cameras x 150 landmarks in equal runs, a
    tenth of the rows masked); ``shuffle``: its rows in a random order, so
    that the camera sums take the padded slots."""
    d, _ = _ba_tests().make_problem(seed=seed, drop=drop)
    if shuffle:
        perm = torch.randperm(d["obs_cam"].shape[0],
                              generator=torch.Generator().manual_seed(seed)).numpy()
        for k in ("obs_cam", "obs_pt", "obs_uv", "obs_mask"):
            d[k] = d[k][perm]
    return convert.ba_problem_from_numpy(d, device=device)


# ---- the earlier form: the landmark order cut to the live rows ------------------------

def old_layout(p, pairs):
    N, L = p.poses.shape[0], p.points.shape[0]
    O = p.obs_cam.shape[0]
    dev = p.obs_cam.device
    run = O // N if O % N == 0 else 0
    equal = ((p.obs_cam == torch.arange(O, device=dev) // run).all() if run
             else p.obs_mask.new_zeros(()))
    key, order = torch.sort(torch.where(p.obs_mask, p.obs_pt * N + p.obs_cam, L * N),
                            stable=True)
    equal, n_live = torch.stack([equal.long(), p.obs_mask.sum()]).tolist()
    key, order = key[:n_live], order[:n_live]
    pt = tba._Segments(L, order, torch.searchsorted(key, torch.arange(L + 1, device=dev) * N))
    pair = (tba._Segments(L * N, order,
                          torch.searchsorted(key, torch.arange(L * N + 1, device=dev)))
            if pairs else None)
    if equal:
        return tba._Layout(tba._Segments(N), pt, pair)
    key, order = torch.sort(torch.where(p.obs_mask, p.obs_cam, N), stable=True)
    start = torch.searchsorted(key, torch.arange(N + 1, device=dev))
    count = start.diff()
    j = torch.arange(int(count.max()), device=dev)
    rows = order[(start[:-1, None] + j).clamp(max=max(O - 1, 0))]
    return tba._Layout(tba._Segments(N, slots=torch.where(j < count[:, None], rows, O)),
                       pt, pair)


@pytest.mark.parametrize("shuffle", [False, True], ids=["equal_runs", "slots"])
@pytest.mark.parametrize("drop", [0.0, 0.1, 0.6])
def test_fixed_shape_layout_keeps_every_segment_sum(shuffle, drop):
    """Camera, landmark and (landmark, camera) sums of J1^T J2 and J^T r
    over the full-length order equal the cut order's bit for bit; the
    order's length is the row count, whatever the mask."""
    p = _problem(seed=3, shuffle=shuffle, drop=drop)
    new, old = tba._layout(p, pairs=True), old_layout(p, pairs=True)
    O = p.obs_cam.shape[0]
    assert (new.cam.slots is None) == (not shuffle)
    assert new.pt.order.shape == new.pair.order.shape == (O,)
    assert torch.equal(new.pt.order[:old.pt.order.shape[0]], old.pt.order)
    assert torch.equal(new.pt.offsets, old.pt.offsets)
    assert torch.equal(new.pair.offsets, old.pair.offsets)
    # masked rows carry values too: no landmark or pair sum may take them
    g = torch.Generator().manual_seed(4)
    J1, J2 = torch.randn(O, 2, 6, generator=g), torch.randn(O, 2, 3, generator=g)
    r = torch.randn(O, 2, generator=g)
    for a, b in zip(new, old):
        assert torch.equal(tba._seg_outer(J1, J2, a), tba._seg_outer(J1, J2, b))
        assert torch.equal(tba._seg_vec(J1, r, a), tba._seg_vec(J1, r, b))


# ---- refine_ba through the cache ----------------------------------------------------

def _stub_cache(monkeypatch):
    cache = graphs.GraphCache(capture=partial(graphs.StageGraph, record=_rerun_into))
    monkeypatch.setattr(graphs, "graphable", lambda dev: True)
    monkeypatch.setattr(graphs, "CACHE", cache)
    return cache


def _ba(p, cfg, group=None):
    """``refine_ba`` under a span; returns its result and the span's counts."""
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("ba"):
            out = tba.refine_ba(p, cfg, group=group)
    (rec,) = [r for r in timer.records() if r["name"] == "ba"]
    timer.clear()
    return out, {k: v for k, v in rec["counts"].items() if "graph" in k}


def _assert_same_ba(a, b):
    assert a[3]["iterations"] == b[3]["iterations"]
    for x, y in zip(a[:3] + (a[3]["final_cost"], a[3]["lambda"]),
                    b[:3] + (b[3]["final_cost"], b[3]["lambda"])):
        assert torch.equal(x, y)


def _stages(cache):
    return [key[2] for key in cache.entries]


@pytest.mark.parametrize("cg_iters", [64, 0], ids=["cg", "cholesky"])
@pytest.mark.parametrize("method", ["lm", "dogleg"])
def test_refine_ba_through_the_cache_keeps_its_bits(method, cg_iters, monkeypatch):
    """Each LM iteration is one key: eager on the first, captured on the
    second, replayed after; the result is the eager run's, bit for bit, and
    the dense CG runs inside the iteration, not through a key of its own."""
    p = _problem(shuffle=method == "dogleg")
    cfg = tba.BAConfig(max_iters=12, tolerance=1e-9, solver="dense", method=method,
                       dense_cg_iters=cg_iters)
    eager, counts = _ba(p, cfg)
    assert counts == {} and eager[3]["iterations"] >= 3
    cache = _stub_cache(monkeypatch)
    graphed, counts = _ba(p, cfg)
    _assert_same_ba(graphed, eager)
    assert counts == {"lm_graph_captures": 1,
                      "lm_graph_replays": eager[3]["iterations"] - 2}
    assert _stages(cache) == ["_lm_iteration"]


def test_problems_with_other_live_rows_share_one_key(monkeypatch):
    """Two windows of one size whose masks differ (other live counts,
    other landmark runs): the second replays the first's graph from its
    first iteration, and each keeps its eager bits."""
    probs = [_problem(seed=s, drop=d) for s, d in ((0, 0.1), (1, 0.3))]
    assert int(probs[0].obs_mask.sum()) != int(probs[1].obs_mask.sum())
    cfg = tba.BAConfig(max_iters=6, tolerance=0.0, solver="dense")
    eager = [_ba(p, cfg)[0] for p in probs]
    cache = _stub_cache(monkeypatch)
    first, c1 = _ba(probs[0], cfg)
    second, c2 = _ba(probs[1], cfg)
    _assert_same_ba(first, eager[0])
    _assert_same_ba(second, eager[1])
    assert c1 == {"lm_graph_captures": 1, "lm_graph_replays": 4}
    assert c2 == {"lm_graph_replays": 6}
    assert len(cache.entries) == 1


@pytest.fixture
def one_rank(tmp_path):
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("method", ["lm", "dogleg"])
def test_pcg_never_reaches_the_cache(method, monkeypatch):
    p = _problem()
    cfg = tba.BAConfig(max_iters=8, solver="pcg", cg_iters=20, method=method)
    eager, _ = _ba(p, cfg)
    cache = _stub_cache(monkeypatch)
    out, counts = _ba(p, cfg)
    _assert_same_ba(out, eager)
    assert counts == {} and not cache.entries


def test_a_process_group_never_puts_the_iteration_in_the_cache(one_rank, monkeypatch):
    """Under a group (its all-reduces run inside the iteration) the
    iteration, its dense CG included, runs eagerly: nothing reaches the
    cache and nothing is counted; the bits are ``refine_ba``'s."""
    p = _problem()
    cfg = tba.BAConfig(max_iters=8, solver="dense")
    plain, _ = _ba(p, cfg)
    cache = _stub_cache(monkeypatch)
    out, counts = _ba(p, cfg, group=one_rank)
    _assert_same_ba(out, plain)
    assert counts == {} and not cache.entries


def old_jacobi_cg(t, iters):
    """``_jacobi_cg`` as it was while a group's CG went through the cache
    alone: a dict of ``A`` and ``b`` in, ``{"x"}`` out."""
    A, b = t["A"], t["b"]
    diag = torch.clamp(A.diagonal(), min=1e-12)
    x = torch.zeros_like(b)
    res = b
    z = b / diag
    pvec = z
    rz = res @ z
    for _ in range(iters):
        Ap = A @ pvec
        alpha = rz / torch.clamp(pvec @ Ap, min=1e-20)
        x = x + alpha * pvec
        res = res - alpha * Ap
        z = res / diag
        rz2 = res @ z
        pvec = z + (rz2 / torch.clamp(rz, min=1e-20)) * pvec
        rz = rz2
    return {"x": x}


def test_jacobi_cg_of_tensors_keeps_the_dict_forms_bits():
    """On fixed SPD systems of a local window's and a global BA's order,
    badly scaled as the damped reduced camera system is."""
    g = torch.Generator().manual_seed(11)
    for n in (98, 602):
        M = torch.randn((n, n), generator=g)
        A = M @ M.t() / n + torch.diag(torch.rand(n, generator=g) * 1e3 + 1e-2)
        b = torch.randn(n, generator=g)
        for iters in (1, 64):
            assert torch.equal(tba._jacobi_cg(A, b, iters),
                               old_jacobi_cg({"A": A, "b": b}, iters)["x"])


# ---- on the card ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cg_iters", [64, 0], ids=["cg", "cholesky"])
@pytest.mark.parametrize("method", ["lm", "dogleg"])
def test_graphed_refine_ba_is_the_eager_one_on_the_card(method, cg_iters, monkeypatch):
    _card()
    cfg = tba.BAConfig(max_iters=12, tolerance=1e-9, solver="dense", method=method,
                       dense_cg_iters=cg_iters)
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache(size=0))
    eager = [_ba(_problem(seed=s, device="cuda"), cfg)[0] for s in (0, 1)]
    monkeypatch.setattr(graphs, "CACHE", graphs.GraphCache())
    first, c1 = _ba(_problem(seed=0, device="cuda"), cfg)
    second, c2 = _ba(_problem(seed=1, device="cuda"), cfg)
    _assert_same_ba(first, eager[0])
    _assert_same_ba(second, eager[1])
    assert c1 == {"lm_graph_captures": 1, "lm_graph_replays": first[3]["iterations"] - 2}
    assert c2 == {"lm_graph_replays": second[3]["iterations"]}


@pytest.mark.cuda
def test_a_replayed_iteration_waits_for_the_card_nowhere(monkeypatch):
    """With the iteration captured, one more iteration (copies in, the
    replay, copies out) under ``set_sync_debug_mode("error")``: only the
    read of ``done``, after it, waits."""
    _card()
    cache = graphs.GraphCache()
    monkeypatch.setattr(graphs, "CACHE", cache)
    p = _problem(device="cuda")
    cfg = tba.BAConfig(max_iters=4, tolerance=0.0, solver="dense")
    poses, points, intr, info = tba.refine_ba(p, cfg)
    assert info["iterations"] == 4
    assert [type(g) for g in cache.entries.values()] == [graphs.StageGraph]
    problem = tba._problem_tensors(p, tba._layout(p, pairs=True))
    state = {"poses": poses, "points": points, "intr": intr, "lam": info["lambda"],
             "cost": info["final_cost"]}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = graphs.staged(tba._lm_iteration, {**state, **problem}, counter="lm_graph",
                            cfg=cfg, dense=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(cache.entries) == 1
    assert isinstance(bool(out["done"]), bool)
