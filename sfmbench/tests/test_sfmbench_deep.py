"""The deep frontend's kind (``frontends/superpoint_lightglue.py`` and its
plain reference), on the CPU: its files are found by name and refuse what
they cannot run (a missing weights file, an open loop, another image size);
the reference loads nothing of the program; the readers of its four
per-layer metrics count by hand, read a synthetic request, give None where
their span or kernel is missing, and read a traced run cut to the CPU's
size, beside the batch cells' readers of the back half that it shares."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import eacham_tpu_torch.features.deep.frontend as deep_frontend
from sfmbench import harness, roofline, run, spans
from sfmbench.entry import Program
from sfmbench_tiny import tiny_copy

HERE = Path(__file__).resolve().parent.parent
CELL = "orbit512_deep.batch"
METRICS = ("deep_tables_s.batch", "masked_attention_roofline.batch", "deep_step_mfu.batch",
           "deep_readbacks.batch")
# the batch cells' readers that the deep cell lists too: the frontend's seconds and
# the shared back half
SHARED = ("extract_s.batch", "sweep_s.batch", "launches_per_frame.batch", "finalize_s.batch",
          "device_idle.batch", "pnp_share.batch", "triangulate_share.batch",
          "local_ba_share.batch", "init_pair_share.batch", "local_ba_iters.batch",
          "global_ba_iters.batch", "readbacks_per_frame.batch", "sweep_graph_share.batch")


def reader(name: str):
    return harness.load_module(HERE / "metrics" / f"{name}.py", name)


def deep_tiny(folder: Path) -> Path:
    """The tiny copy, with the deep configuration's matcher normalising by the
    tiny frames' size (256 x 192)."""
    here = tiny_copy(folder)
    path = here / "configs" / "orbit512_deep.json"
    conf = json.loads(path.read_text())
    conf["frontend"]["normalize_size"] = [256, 192]
    path.write_text(json.dumps(conf))
    return here


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return deep_tiny(tmp_path_factory.mktemp("tiny"))


# ---- the kind's files ----------------------------------------------------------------

def test_the_cell_finds_its_kind_and_metrics():
    c = harness.cell(CELL)
    assert c["frontend"].__file__ == str(HERE / "frontends" / "superpoint_lightglue.py")
    assert c["reference"].__file__ == str(HERE / "reference" / "frontends"
                                         / "superpoint_lightglue.py")
    assert c["frontend"].STREAMS is False
    assert c["frontend"].kernels(c["config"]) == ["masked_attention"]
    assert set(METRICS) | set(SHARED) <= set(c["readers"])
    assert [m["name"] for m in c["end_to_end"]] == ["sfm_frames_per_s", "setup_s"]
    assert harness.check_spec(c)["pairs"] == {"window": 10, "retrieval_k": 3, "ladder": True,
                                              "symmetric": True}
    assert "match_ratio" not in c["config"]["check"]


def test_an_open_loop_is_refused(here):
    bench_path = here.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "orbit512_deep.stream", "config": "orbit512_deep",
                               "traffic": "stream", "chips": 1, "why": "test"})
    bench_path.write_text(json.dumps(bench))
    with pytest.raises(harness.CellError, match="does not stream"):
        harness.cell("orbit512_deep.stream", here=here)


def test_missing_weights_are_refused(here, tmp_path, monkeypatch):
    """No random weights: without ``superpoint.npz`` or ``lightglue.npz`` the
    set-up fails with CellError."""
    real = deep_frontend.load_frontend_params
    c = harness.cell(CELL, here=here)
    inputs = {"images": torch.zeros(2, 192, 256).numpy(), "poses": None,
              "intr": [300.0, 300.0, 128.0, 96.0], "size": (256, 192)}
    weights = HERE.parent / "weights"
    for present in ("superpoint.npz", "lightglue.npz"):
        folder = tmp_path / present
        folder.mkdir()
        (folder / present).write_bytes((weights / present).read_bytes())
        (folder / "lightglue.meta").write_bytes((weights / "lightglue.meta").read_bytes())
        monkeypatch.setattr(deep_frontend, "load_frontend_params",
                            lambda device, folder=folder: real(weights_dir=folder, device=device))
        with pytest.raises(harness.CellError, match="no weights"):
            Program(c["config"], c["traffic"], inputs, 1, torch.device("cpu"), c["frontend"])


def test_another_image_size_is_refused(tmp_path):
    here = tiny_copy(tmp_path)           # normalize_size left at 512 x 384
    c = harness.cell(CELL, here=here)
    inputs = harness.make_inputs(c["config"], here=here)
    with pytest.raises(harness.CellError, match="normalize_size"):
        Program(c["config"], c["traffic"], inputs, 1, torch.device("cpu"), c["frontend"])


def test_a_missing_kind_file_is_refused_by_name(tmp_path):
    here = deep_tiny(tmp_path)
    (here / "frontends" / "superpoint_lightglue.py").unlink()
    with pytest.raises(harness.CellError, match="frontends/superpoint_lightglue.py"):
        harness.cell(CELL, here=here)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import sfmbench.reference.frontends.superpoint_lightglue; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('eacham_tpu_torch', 'eacham_tpu', 'jax')]; print(bad); assert not bad"
            % str(HERE.parent))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---- the readers ---------------------------------------------------------------------

def test_kernel_3s_work_by_hand():
    # three frames of K 8 with 8, 5 and 2 live keypoints; pairs (0, 1), (1, 2)
    # and two (0, 0) padding rows, two layers
    mask = torch.zeros(3, 8, dtype=torch.bool)
    mask[0, :8], mask[1, :5], mask[2, :2] = True, True, True
    pairs = torch.tensor([[0, 1], [1, 2], [0, 0], [0, 0]])
    flops, nbytes = reader("masked_attention_roofline.batch").work(pairs, mask, 2)
    # a block row: 4 heads x 8 queries x live keys x 64, four FLOP a query-key-dim;
    # per pair and layer the blocks see frame i's keys twice and frame j's twice
    live_keys = 2 * 2 * ((8 + 5) + (5 + 2))
    assert flops == 4 * 4 * 8 * 64 * live_keys
    rows = 4 * 2 * 2
    assert nbytes == 4 * rows * 4 * 64 * (2 * 8 + 2 * 8) + rows * 8
    # the pad rows alone are no work
    assert reader("masked_attention_roofline.batch").work(pairs[2:], mask, 2) == (0.0, 0.0)


def synthetic_request(frames=100, k=1024, real=1400, pad=136, total_s=6.0, profiled=False):
    pairs = torch.zeros(real + pad, 2, dtype=torch.long)
    pairs[:real, 0] = torch.arange(real) % (frames - 1)
    pairs[:real, 1] = pairs[:real, 0] + 1
    return {"frames": frames, "total_s": total_s, "profiled": profiled,
            "out": {"desc": torch.zeros(frames, k, 4), "mask": torch.ones(frames, k, dtype=torch.bool),
                    "scene": {"pair_idx": pairs}}}


def test_the_mfu_reader_on_a_synthetic_request():
    config = json.loads((HERE / "configs" / "orbit512_deep.json").read_text())
    ctx = {"config": config, "requests": [synthetic_request(), synthetic_request(total_s=4.0),
                                          synthetic_request(total_s=100.0, profiled=True)]}
    want = (roofline.superpoint_flops(100, 384, 512)
            + roofline.attention_matcher_flops(1400, 1024, 3)) / (5.0 * roofline.PEAK_TF32_FLOPS)
    got = reader("deep_step_mfu.batch").read(ctx)
    assert got == pytest.approx(100 * want, rel=1e-12)
    assert 1.0 < got < 2.0           # about 4.6e13 FLOP a request in 5 s
    # a frame size the cells do not divide is padded as the network is handed it
    config["inputs"]["height"] = 380
    assert reader("deep_step_mfu.batch").read(ctx) == pytest.approx(got, rel=1e-12)


def test_the_roofline_reader_on_a_synthetic_trace():
    config = json.loads((HERE / "configs" / "orbit512_deep.json").read_text())
    req = synthetic_request()
    flops, nbytes = reader("masked_attention_roofline.batch").work(
        req["out"]["scene"]["pair_idx"], req["out"]["mask"], 3)
    # every key live: 12 blocks of [1400, 4, 1024, 64] at 3.436e10 FLOP a [32, 4, ...] launch
    assert flops == pytest.approx(12 * 1400 / 32 * 3.436e10, rel=1e-3)
    bound = roofline.bound_seconds(flops, nbytes, roofline.PEAK_TF32_FLOPS)
    trace = {"by_name": {"masked_attention_kernel(float const*, ...)": (10 * bound, 576),
                         "other": (1.0, 3)}}
    ctx = {"config": config, "trace": trace, "traced_request": req}
    assert reader("masked_attention_roofline.batch").read(ctx) == pytest.approx(10.0)


def test_the_readers_give_none_without_their_span_or_kernel(monkeypatch):
    config = json.loads((HERE / "configs" / "orbit512_deep.json").read_text())
    ctx = {"config": config, "trace": {"by_name": {"other": (1.0, 3)}},
           "traced_request": synthetic_request(), "requests": []}
    assert reader("masked_attention_roofline.batch").read(ctx) is None
    assert reader("masked_attention_roofline.batch").read(dict(ctx, trace=None)) is None
    for name in ("extract_s.batch", "deep_tables_s.batch", "deep_step_mfu.batch"):
        assert reader(name).read(ctx) is None, name
    # a program that keeps no spans, or whose request recorded only one of the two
    monkeypatch.setattr(spans, "records", lambda: None)
    assert reader("deep_readbacks.batch").read(ctx) is None
    only_extract = [{"name": "features.deep.extract", "start_ns": 0, "end_ns": 5, "parent": None,
                     "root": 0, "attrs": {}, "counts": {"readbacks": 13}}]
    monkeypatch.setattr(spans, "records", lambda: only_extract)
    assert reader("deep_readbacks.batch").read(ctx) is None
    both = only_extract + [
        {"name": "sfm.matches.deep", "start_ns": 6, "end_ns": 9, "parent": None, "root": 1,
         "attrs": {}, "counts": {}},
        {"name": "sfm.matches.deep.pairs", "start_ns": 6, "end_ns": 7, "parent": 1, "root": 1,
         "attrs": {}, "counts": {"readbacks": 2}}]
    monkeypatch.setattr(spans, "records", lambda: both)
    assert reader("deep_readbacks.batch").read(ctx) == 15.0
    assert reader("deep_readbacks.batch").read(dict(ctx, traced_request=None)) is None


# ---- a traced run at the CPU's size ----------------------------------------------------

def test_a_traced_run_reads_the_deep_spans(here):
    from eacham_tpu_torch.utils import timer

    timer.clear()
    res = run.run(CELL, 2 ** 33 + 9, 0.1, True, device=torch.device("cpu"), here=here)
    recs = timer.records()
    timer.clear()
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU runs kernel 3's plain version: no kernel in the trace, no roofline; and
    # the sweep's stages eagerly: no graph captured or replayed
    assert set(got) == (set(METRICS) | set(SHARED)) - {"masked_attention_roofline.batch",
                                                       "sweep_graph_share.batch"}
    assert got["extract_s.batch"] > 0 and got["deep_tables_s.batch"] > 0
    assert got["sweep_s.batch"] > 0 and got["finalize_s.batch"] > 0
    assert 0 < got["deep_step_mfu.batch"] < 100
    names = {r["name"] for r in recs}
    assert {"features.deep.extract", "sfm.matches.deep", "sfm.matches.deep.pairs",
            "sfm.matches.deep.match", "sfm.matches.deep.verify"} <= names
    extract = [r for r in recs if r["name"] == "features.deep.extract"][-1]
    assert extract["counts"] == {"frames": 12, "chunks": 2, "readbacks": 2}
    match = [r for r in recs if r["name"] == "sfm.matches.deep.match"][-1]
    pairs = [r for r in recs if r["name"] == "sfm.matches.deep.pairs"][-1]
    # 12 frames, window 10: 65 window pairs and one retrieval slot a frame, padded to
    # 64-row buckets, then to whole 32-pair chunks; 4 blocks a layer, 3 layers
    assert pairs["counts"] == {"readbacks": 2}
    assert match["counts"]["readbacks"] == 1
    rows = match["counts"]["rows"]
    assert rows % 32 == 0 and rows >= match["counts"]["pairs"] >= 65
    assert match["counts"]["attention_calls"] == rows // 32 * 4 * 3
    # verification refits each 1024-pair chunk's essential matrices once: eigh's and
    # svd's status reads (one and two) and the diagonal's upload
    verify = [r for r in recs if r["name"] == "sfm.matches.deep.verify"][-1]
    assert verify["counts"] == {"readbacks": 4}
    assert got["deep_readbacks.batch"] == 2 + 2 + 1 + 4
    assert set(res["checks"]) >= {"kp_gap_px", "match_extra", "ate", "unregistered"}
    assert all(c["value"] is not None for c in res["checks"].values())
