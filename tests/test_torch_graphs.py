"""The port's graph cache (``eacham_tpu_torch.graphs``), on the CPU with
stand-in capturers: a key's eager first use, its capture on the second and
its replays after, the bound, the counts on the span, what the key follows,
the static inputs' copy-in rule; and the cache's place below ``ba`` and
``sfm``: its own imports, and a dense ``refine_ba`` that loads no module of
the sweep."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from eacham_tpu_torch import graphs
from eacham_tpu_torch.utils import timer

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


class StubGraph:
    """Records its captures; a call reruns the stage."""

    made: list = []

    def __init__(self, fn, inputs):
        self.fn = fn
        self.made.append(sorted(inputs))

    def __call__(self, inputs):
        return {"y": self.fn(inputs)["y"] + 1000}


def _rerun_into(fn, static):
    """A CPU stand-in for a capture: the outputs are fixed tensors that each
    replay overwrites, as a graph's are."""
    out = fn(static)
    return (lambda: [out[k].copy_(v) for k, v in fn(static).items()]), out


def test_cache_runs_eager_then_captures_then_replays():
    StubGraph.made = []
    cache = graphs.GraphCache(size=3, capture=StubGraph)
    eager = []

    def fn(t):
        eager.append(1)
        return {"y": t["x"] * 2}

    x = torch.ones(2)
    assert cache.run("a", fn, {"x": x})["y"].tolist() == [2, 2]     # first use: eager
    assert len(eager) == 1 and StubGraph.made == [] and cache.entries["a"] is None
    assert cache.run("a", fn, {"x": x})["y"].tolist() == [1002, 1002]   # second: captured
    assert StubGraph.made == [["x"]]
    assert cache.run("a", fn, {"x": x})["y"].tolist() == [1002, 1002]   # then replayed
    assert StubGraph.made == [["x"]]
    for k in ("b", "c", "d"):
        cache.run(k, fn, {"x": x})
    # the bound: the least recently used key went; it starts over, eagerly
    assert list(cache.entries) == ["b", "c", "d"]
    assert cache.run("a", fn, {"x": x})["y"].tolist() == [2, 2]
    assert "b" not in cache.entries and len(cache.entries) == 3
    # a cache of size 0 runs everything eagerly
    zero = graphs.GraphCache(size=0, capture=StubGraph)
    for _ in range(3):
        assert zero.run("a", fn, {"x": x})["y"].tolist() == [2, 2]
    assert StubGraph.made == [["x"]] and not zero.entries


def test_cache_counts_captures_and_replays_on_the_span():
    StubGraph.made = []
    cache = graphs.GraphCache(capture=StubGraph)
    timer.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.span("stage"):
            for _ in range(4):
                cache.run("k", lambda t: {"y": t["x"]}, {"x": torch.zeros(1)})
    (rec,) = timer.records()
    timer.clear()
    assert rec["counts"] == {"graph_captures": 1, "graph_replays": 2}


def test_keys_follow_shapes_dtypes_and_options(monkeypatch):
    keys = []

    class Keys:
        def run(self, key, fn, inputs, counter):
            keys.append(key)
            return fn(inputs)

    assert graphs.graphable(torch.device("cpu")) is False
    monkeypatch.setattr(graphs, "CACHE", Keys())
    monkeypatch.setattr(graphs, "graphable", lambda dev: True)

    def stage(t, a):
        return {"y": t["cur"] + a}

    base = {"cur": torch.zeros(1, dtype=torch.int64), "x": torch.zeros(4, 3)}
    graphs.staged(stage, base, a=1)
    graphs.staged(stage, {**base, "cur": torch.ones(1, dtype=torch.int64)}, a=1)
    graphs.staged(stage, {**base, "x": torch.zeros(5, 3)}, a=1)
    graphs.staged(stage, {**base, "x": torch.zeros(4, 3, dtype=torch.float64)}, a=1)
    graphs.staged(stage, base, a=2)
    assert keys[0] == keys[1]          # another frame, the same graph
    assert len(set(keys[1:])) == 4     # a shape, a dtype or an option: a new key


def test_static_inputs_follow_new_and_rewritten_tensors():
    fixed = torch.arange(4.0)
    g = graphs.StageGraph(lambda t: {"y": t["a"] + t["b"]},
                          {"a": fixed, "b": torch.ones(4)}, record=_rerun_into)
    first = g({"a": fixed, "b": torch.ones(4)})
    assert first["y"].tolist() == [1, 2, 3, 4]
    fixed.add_(10)                      # written in place: copied in again
    second = g({"a": fixed, "b": torch.zeros(4)})
    assert second["y"].tolist() == [10, 11, 12, 13]
    assert first["y"].tolist() == [1, 2, 3, 4]     # no output aliases the graph's
    # inference tensors keep no count of in-place writes: copied in on every call
    with torch.inference_mode():
        a = torch.arange(4.0)
        g = graphs.StageGraph(lambda t: {"y": t["a"] * 2}, {"a": a}, record=_rerun_into)
        a.add_(1)
        assert g({"a": a})["y"].tolist() == [2, 4, 6, 8]


def test_a_dense_refine_ba_loads_no_module_of_the_sweep(tmp_path):
    """The cache sits below ``ba`` and ``sfm``: a fresh interpreter that runs
    a dense ``refine_ba`` on the CPU has imported the cache and no
    ``eacham_tpu_torch.sfm`` module."""
    g = torch.Generator().manual_seed(0)
    N, L = 4, 30
    poses = torch.eye(4).repeat(N, 1, 1)
    poses[:, 0, 3] = torch.arange(N) * 0.2
    points = torch.rand((L, 3), generator=g) - 0.5
    points[:, 2] += 4.0
    intr = torch.tensor([200.0, 200.0, 64.0, 48.0])
    obs_cam, obs_pt = torch.arange(N).repeat_interleave(L), torch.arange(L).repeat(N)
    pc = points[obs_pt] + poses[obs_cam, :3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 200.0 + intr[2:] + torch.randn((N * L, 2), generator=g)
    torch.save(dict(poses=poses, points=points, intr=intr, obs_cam=obs_cam, obs_pt=obs_pt,
                    obs_uv=uv, obs_mask=torch.ones(N * L, dtype=torch.bool),
                    cam_in_ba=torch.ones(N, dtype=torch.bool),
                    cam_fixed=torch.arange(N) < 2, pt_in_ba=torch.ones(L, dtype=torch.bool),
                    pt_obs_count=torch.full((L,), float(N))), tmp_path / "p.pt")
    code = "\n".join([
        "import json, sys, torch",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from eacham_tpu_torch.ba import core",
        f"p = core.BAProblem(**torch.load({str(tmp_path / 'p.pt')!r}))",
        "out = core.refine_ba(p, core.BAConfig(max_iters=3, solver='dense'))",
        "assert out[3]['iterations'] >= 1",
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('eacham_tpu_torch.'))))",
    ])
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert run.returncode == 0, run.stderr
    loaded = json.loads(run.stdout.strip().splitlines()[-1])
    assert "eacham_tpu_torch.graphs" in loaded
    assert [m for m in loaded if m.startswith("eacham_tpu_torch.sfm")] == []


def _imports(path: Path) -> set:
    """Every name a module imports, anywhere in it (``from a import b``: ``a.b``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def test_the_cache_imports_nothing_of_the_port_but_the_timer():
    """Of the port, ``graphs`` imports ``utils.timer`` alone, and no module
    under ``ba`` imports from ``sfm``, at its top or inside a function."""
    pkg = ROOT / "eacham_tpu_torch"
    assert {m for m in _imports(pkg / "graphs.py")
            if m.startswith("eacham_tpu_torch")} == {"eacham_tpu_torch.utils.timer"}
    for path in (pkg / "ba").glob("*.py"):
        assert not [m for m in _imports(path) if m.startswith("eacham_tpu_torch.sfm")], path
    assert "eacham_tpu_torch.graphs" in _imports(pkg / "ba" / "core.py")
