"""The reader of the share of replayed LM iterations
(``metrics/ba_graph_share.batch.py``) on recorded spans."""

import importlib.util
from pathlib import Path

import pytest

from sfmbench import spans


def _reader():
    path = Path(__file__).resolve().parents[1] / "metrics" / "ba_graph_share.batch.py"
    spec = importlib.util.spec_from_file_location("ba_graph_share_batch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(name, parent, root, counts):
    return {"name": name, "start_ns": 0, "end_ns": 1, "parent": parent, "root": root,
            "attrs": {}, "counts": counts}


def _records(counted):
    """An earlier request (root 0) and the traced one (root 1): three local
    BAs of 5 iterations and a global BA of 50, the first local BA's key
    eager once and captured once; the CG's own counts beside them."""
    out = [_rec("sfm.pipeline.run_sfm", None, 0, {}),
           _rec("sfm.device_loop.local_ba", 0, 0, {"iterations": 5, "lm_graph_replays": 5}),
           _rec("sfm.pipeline.run_sfm", None, 1, {}), _rec("sfm.device_loop", 2, 1, {})]
    lm = [{"lm_graph_captures": 1, "lm_graph_replays": 3}, {"lm_graph_replays": 5},
          {"lm_graph_replays": 5}]
    for c in lm:
        out.append(_rec("sfm.device_loop.local_ba", 3, 1,
                        {"iterations": 5, "graph_replays": 5, **(c if counted else {})}))
    out.append(_rec("sfm.pipeline._finalize", 2, 1, {}))
    out.append(_rec("ba.global", len(out) - 1, 1,
                    {"iterations": 50, **({"lm_graph_replays": 50} if counted else {})}))
    return out


def test_the_benchmark_reads_the_share_of_replayed_lm_iterations(monkeypatch):
    reader = _reader()
    ctx = {"traced_request": {"registered": 3}}
    monkeypatch.setattr(spans, "records", lambda: _records(True))
    assert reader.read(ctx) == pytest.approx(100.0 * 63 / 65)
    # a program that counts neither (no iteration graphs): nothing to read
    monkeypatch.setattr(spans, "records", lambda: _records(False))
    assert reader.read(ctx) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert reader.read(ctx) is None
    assert reader.read({"traced_request": None}) is None
