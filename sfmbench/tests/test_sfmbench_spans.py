"""The readers of the program's own spans (``sfmbench/spans.py``), on a
traced run of each cell cut to the CPU's size, and on a program that keeps
no spans."""

import pytest
import torch

from sfmbench import run, spans
from sfmbench_tiny import tiny_copy

BATCH = ("pnp_share.batch", "triangulate_share.batch", "local_ba_share.batch",
         "init_pair_share.batch", "local_ba_iters.batch", "global_ba_iters.batch",
         "readbacks_per_frame.batch")
STREAM = ("chunk_resume_share.stream", "global_ba_iters.stream")


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def traced(here):
    from eacham_tpu_torch.utils import timer

    timer.clear()
    out = {w: run.run(w, 2 ** 33 + 7, 0.1, True, device=torch.device("cpu"), here=here)
           for w in ("orbit512_dog.batch", "orbit512_dog.stream")}
    timer.clear()
    return out


def test_every_span_metric_is_read_in_a_traced_run(traced):
    got = {w: {k: v["value"] for k, v in r["metrics"].items()} for w, r in traced.items()}
    batch, stream = got["orbit512_dog.batch"], got["orbit512_dog.stream"]
    assert set(BATCH) <= set(batch) and not set(STREAM) & set(batch)
    assert set(STREAM) <= set(stream) and not set(BATCH) & set(stream)
    parts = [batch[k] for k in ("pnp_share.batch", "triangulate_share.batch",
                                "local_ba_share.batch")]
    assert all(0 < p < 100 for p in parts) and sum(parts) < 100
    assert 0 < batch["init_pair_share.batch"] < 100
    assert 0 < stream["chunk_resume_share.stream"] < 100
    # the tiny configuration keeps the cell's budgets: at most 5 local and 50 global iterations
    assert 1 <= batch["local_ba_iters.batch"] <= 5
    assert 1 <= batch["global_ba_iters.batch"] <= 50
    assert 1 <= stream["global_ba_iters.stream"] <= 50
    # each registration reads its candidate (next_best_view: the candidate and
    # five 0-d indices) and its inlier count; PnP's solves no longer wait
    assert batch["readbacks_per_frame.batch"] >= 7
    assert all(r["correct"] for r in traced.values())


def test_a_run_without_the_profiler_records_nothing(here):
    from eacham_tpu_torch.utils import timer

    timer.clear()
    res = run.run("orbit512_dog.batch", 11, 0.1, False, device=torch.device("cpu"), here=here)
    assert timer.records() == [] and res["correct"]


def test_the_readers_return_none_without_spans(monkeypatch):
    ctx = {"traced_request": {"registered": 12}, "stream": {"latencies": []}, "trace": {}}
    monkeypatch.setattr(spans, "records", lambda: None)
    assert spans.batch(ctx) is None and spans.stream(ctx) is None
    assert spans.share(None, "a", "b") is None and spans.mean_count(None, "a", "b") is None


def test_tree_names_and_counts():
    recs = [
        {"name": "root", "start_ns": 0, "end_ns": 100, "parent": None, "root": 0,
         "attrs": {}, "counts": {"registered": 2}},
        {"name": "a", "start_ns": 10, "end_ns": 40, "parent": 0, "root": 0, "attrs": {},
         "counts": {"readbacks": 3}},
        {"name": "b", "start_ns": 50, "end_ns": 60, "parent": 0, "root": 0, "attrs": {},
         "counts": {"readbacks": 1}},
        {"name": "a", "start_ns": 200, "end_ns": 300, "parent": None, "root": 1, "attrs": {},
         "counts": {}},
    ]
    tree = spans.Tree(recs, {0})
    assert tree.named("a") == [1] and tree.named("b", under=[0]) == [2]
    assert tree.seconds([1, 2]) == pytest.approx(40e-9)
    assert tree.count([0], "readbacks", deep=True) == 4 and tree.count([0], "readbacks") == 0
    assert spans.share(tree, "a", "root") == pytest.approx(30.0)
    assert spans.mean_count(tree, "root", "registered") == 2
