"""A configuration, a traffic mix and a metric added as files (and named in
BENCHMARK.json) are taken with no edit to any file that is there."""

import json
from pathlib import Path

import torch

from sfmbench import harness, run
from sfmbench_tiny import tiny_copy

HERE = Path(__file__).resolve().parent.parent


def snapshot(folder: Path) -> dict:
    return {p.relative_to(folder): p.read_bytes() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_files_added_by_name_are_picked_up(tmp_path):
    here = tiny_copy(tmp_path)
    before = snapshot(here)
    conf = json.loads((here / "configs" / "stress100_tracks.json").read_text())
    conf["name"] = "stress_small"
    conf["inputs"]["points"] = 128
    (here / "configs" / "stress_small.json").write_text(json.dumps(conf))
    traffic = json.loads((here / "traffic" / "batch.json").read_text())
    traffic["warmup_frames"] = 4
    (here / "traffic" / "batch_short_warmup.json").write_text(json.dumps(traffic))
    (here / "metrics" / "requests_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['requests']))\n")
    limits = json.loads((here / "limits" / "stress100_tracks.batch.json").read_text())
    (here / "limits" / "stress_small.batch_short_warmup.json").write_text(json.dumps(limits))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stress_small", "source": "https://example.org",
                             "file": "sfmbench/configs/stress_small.json", "reduced": ["points"],
                             "why": "test"})
    bench["workloads"].append({"name": "stress_small.batch_short_warmup", "config": "stress_small",
                               "traffic": "batch_short_warmup", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "sfm_frames_per_s":
            m["workloads"].append("stress_small.batch_short_warmup")
    bench["per_layer"].append({"name": "requests_in_window", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "sfm_frames_per_s",
                               "workloads": ["stress_small.batch_short_warmup"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # no file that was there changed
    assert all(snapshot(here)[k] == v for k, v in before.items())

    c = harness.cell("stress_small.batch_short_warmup", here=here)
    assert c["config"]["inputs"]["points"] == 128 and c["traffic"]["warmup_frames"] == 4
    assert "requests_in_window" in c["readers"]
    res = run.run("stress_small.batch_short_warmup", 5, 0.1, True, device=torch.device("cpu"),
                  here=here)
    assert res["metrics"]["requests_in_window"]["value"] >= 2
    res = run.run("stress_small.batch_short_warmup", 5, 0.1, False, device=torch.device("cpu"),
                  here=here)
    assert set(res["metrics"]) == {"sfm_frames_per_s", "setup_s"}
    assert res["attempted"] == 12 * len(res["diagnostics"]["requests"])


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = harness.cell(w["name"])
        assert c["limits"] is not None, w["name"]
        names = {m["name"] for m in c["end_to_end"] + c["per_layer"]}
        assert names == set(c["readers"])
        assert "setup_s" in names and len(c["end_to_end"]) >= 2 and c["per_layer"]
