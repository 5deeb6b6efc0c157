"""The result line of a run, driven on the CPU at a small size (the look
for a card skipped): its keys, in the contract's order, with trace off and
on, and the numbers compared printed beside their limits."""

import json

import pytest
import torch

from sfmbench import run
from sfmbench_tiny import tiny_copy


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", ["orbit512_dog.batch", "orbit512_dog.stream"])
def test_the_last_line(here, workload):
    res = run.run(workload, 2 ** 31 + 12345, 0.2, False, device=torch.device("cpu"), here=here)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["device"]["count"] == 1
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 12 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res, allow_nan=False))


def test_a_traced_run(here):
    res = run.run("orbit512_dog.batch", 3, 0.1, True, device=torch.device("cpu"), here=here)
    assert {"launches_per_frame.batch", "sweep_s.batch"} <= set(res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    assert list(res)[-1] == "checks"


def test_a_cell_without_limits_is_not_correct(here, tmp_path):
    (here / "limits" / "orbit512_dog.batch.json").rename(tmp_path / "l.json")
    try:
        res = run.run("orbit512_dog.batch", 3, 0.1, False, device=torch.device("cpu"),
                      here=here)
    finally:
        (tmp_path / "l.json").rename(here / "limits" / "orbit512_dog.batch.json")
    assert res["correct"] is False
    assert all(c["limit"] is None for c in res["checks"].values())


def test_the_checks_go_to_standard_error_last(here, monkeypatch, capsys):
    monkeypatch.setattr(run, "run", lambda *a, **k: {
        "correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
        "checks": {"ate": {"value": 0.02, "limit": 0.1}}})
    assert run.main(["--workload", "x", "--seed", "1", "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    assert err.strip().splitlines()[-1] == "check ate: 0.02 limit 0.1"
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
