"""Frontend kinds found by file (``frontends/<kind>.py`` and
``reference/frontends/<kind>.py``), on the CPU at the tiny size: a new kind
is taken with new files and entries alone, and the tables it builds reach
``run_sfm``; a kind without its files is refused by name; the DoG kind's
judge numbers are the ones the judge gave before kinds were files; the
stated candidate pairs follow ``sfm.matches.candidate_pairs``, ladder and
all; and a configuration's frontend block states its closed loop's pairs."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import eacham_tpu_torch.sfm.pipeline as pipeline
from eacham_tpu_torch.sfm.matches import bucket_pairs, candidate_pairs
from sfmbench import harness
from sfmbench.entry import Program
from sfmbench.reference.judge import judge_pairs, judge_request, stated_pairs
from sfmbench_tiny import tiny_copy

SEED = 2 ** 33 + 5
THREADS = 4

TABLES_KIND = '''"""The DoG frontend with the match graph built by the kind itself, by the
call run_sfm makes for this configuration (pair_window 0, verification on)."""

from sfmbench.frontends.dog import STREAMS, extract, kernels, setup  # noqa: F401


def match_tables(prog, xy, desc, mask, opts, generator):
    import torch

    from eacham_tpu_torch.sfm.matches import build_match_tables

    intr = torch.as_tensor(prog.intr, dtype=torch.float32, device=prog.dev)
    return build_match_tables(
        desc, mask, ratio=opts.match_ratio, min_matches=opts.min_matches,
        chunk=opts.match_chunk,
        verify=(xy, intr, generator, opts.max_repr_error, opts.verify_hyps))
'''
TABLES_REFERENCE = ("from sfmbench.reference.frontends.dog import (  # noqa: F401\n"
                    "    judge_frontend, reference_matches)\n")


def snapshot(folder: Path) -> dict:
    return {p.relative_to(folder): p.read_bytes() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(here: Path, name: str, kind: str, traffic: str = "batch", **frontend) -> str:
    """A configuration ``name``: the tiny orbit's with ``frontend.kind`` = kind
    (and ``frontend``'s other keys), its limits file and its BENCHMARK.json
    entries, all new. Returns the cell's name."""
    conf = json.loads((here / "configs" / "orbit512_dog.json").read_text())
    conf["name"] = name
    conf["frontend"].update(kind=kind, **frontend)
    (here / "configs" / f"{name}.json").write_text(json.dumps(conf))
    limits = (here / "limits" / f"orbit512_dog.{traffic}.json").read_text()
    (here / "limits" / f"{name}.{traffic}.json").write_text(limits)
    bench_path = here.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": name, "source": "https://example.org",
                             "file": f"sfmbench/configs/{name}.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": f"{name}.{traffic}", "config": name,
                               "traffic": traffic, "chips": 1, "why": "test"})
    bench_path.write_text(json.dumps(bench))
    return f"{name}.{traffic}"


@pytest.fixture(scope="module", autouse=True)
def threads():
    """Four CPU threads, as the frozen numbers were read with: the program's
    CPU outputs depend on how its reductions are split over threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def first_request(here: Path, workload: str) -> dict:
    """The first request of a closed-loop cell, and what the judge needs."""
    c = harness.cell(workload, here=here)
    inputs = harness.make_inputs(c["config"], here=here)
    prog = Program(c["config"], c["traffic"], inputs, SEED, torch.device("cpu"), c["frontend"])
    truth = {"images": inputs.get("images"), "poses": inputs["poses"], "intr": inputs["intr"]}
    return {"cell": c, "inputs": inputs, "truth": truth, "record": prog.reconstruct(0)}


@pytest.fixture(scope="module")
def dog_batch(here):
    return first_request(here, "orbit512_dog.batch")


def judged(c, out, truth, control=None) -> dict:
    rng = np.random.default_rng(harness.sample_seed(SEED))
    return judge_request(out, truth, harness.check_spec(c), rng, control)


# ---- a new kind's tables reach run_sfm -----------------------------------------------

def test_a_kinds_own_tables_reach_run_sfm(here, dog_batch, monkeypatch):
    before = snapshot(here)
    (here / "frontends" / "dog_tables.py").write_text(TABLES_KIND)
    (here / "reference" / "frontends" / "dog_tables.py").write_text(TABLES_REFERENCE)
    workload = add_cell(here, "orbit512_tables", "dog_tables")
    assert all(snapshot(here)[k] == v for k, v in before.items())

    c = harness.cell(workload, here=here)
    assert c["frontend"].__file__ == str(here / "frontends" / "dog_tables.py")

    def no_own_graph(*a, **k):
        raise AssertionError("run_sfm built its own match graph")

    monkeypatch.setattr(pipeline, "build_match_tables", no_own_graph)
    prog = Program(c["config"], c["traffic"], dog_batch["inputs"], SEED, torch.device("cpu"),
                   c["frontend"])
    rec = prog.reconstruct(0)
    ref = dog_batch["record"]
    assert ref["tables_s"] is None and rec["tables_s"] > 0
    assert rec["registered"] == ref["registered"]
    # the same call with the same generator: the same scene, bit for bit
    for k, v in ref["out"]["scene"].items():
        if torch.is_tensor(v):
            assert torch.equal(rec["out"]["scene"][k], v), k
    # the kind's reference, found by name, judges as the DoG kind's
    assert judged(c, rec["out"], dog_batch["truth"]) == judged(
        dog_batch["cell"], ref["out"], dog_batch["truth"])


# ---- a kind without its files --------------------------------------------------------

def test_a_kind_without_a_file_is_refused_by_name(here):
    workload = add_cell(here, "orbit512_nokind", "nokind")
    with pytest.raises(harness.CellError, match=re.escape("frontends/nokind.py")):
        harness.cell(workload, here=here)
    (here / "frontends" / "nokind.py").write_text("STREAMS = False\n")
    with pytest.raises(harness.CellError, match=re.escape("reference/frontends/nokind.py")):
        harness.cell(workload, here=here)
    (here / "reference" / "frontends" / "nokind.py").write_text("")
    assert harness.cell(workload, here=here)["frontend"].STREAMS is False
    with pytest.raises(harness.CellError, match="does not stream"):
        harness.cell(add_cell(here, "orbit512_nokind_s", "nokind", traffic="stream"), here=here)


# ---- the judge's numbers as they were before kinds were files -----------------------

# The judge's numbers before kinds were files, on the program's first request
# of the DoG batch cell and of the tracks (frontend null: run_sfm's own
# matching rule, the "no_ratio" control), frozen from that tree's judge at
# THREADS threads. The sums of the program's outputs are frozen beside them:
# where the program's CPU outputs move (another CPU's kernels may round them
# otherwise), the frozen numbers do not apply, and the test says so.
FROZEN = {'orbit512_dog.batch': {'sums': {'keypoints': 642638.2175970078,
                                 'kp_mask': 3072.0,
                                 'pose': 57.10066462368923,
                                 'pose_valid': 12.0,
                                 'pose_fixed': 1.0,
                                 'pair_idx': 726.0,
                                 'pair_ok': 66.0,
                                 'match_ij': 3942272.0,
                                 'valid_ij': 10103.0,
                                 'match_ji': 1191153.0,
                                 'valid_ji': 10103.0,
                                 'points': 9205.525669035502,
                                 'lm_valid': 232.0,
                                 'lm_two_view': 96.0,
                                 'n_landmarks': 339.0,
                                 'kp2lm': 424616.0,
                                 'intr': 835.2734375,
                                 'xy': 642638.2175970078,
                                 'desc': 32893.575181073546,
                                 'mask': 3072.0},
                        'program': {'unregistered': 0.0,
                                    'ate': 0.03348587499972685,
                                    'kp_unpaired': 0.0,
                                    'kp_gap_px': 0.00013164324254316722,
                                    'desc_gap': 2.4334254606178655e-06,
                                    'pairs_missing': 0.0,
                                    'match_extra': 0.0,
                                    'match_missing': 0.0,
                                    'epi_bad': 0.0106898940908641,
                                    'pose_gain': 2.2533179495693763e-06,
                                    'point_gain': 4.146898317766973e-06},
                        'control': {'unregistered': 0.0,
                                    'ate': 0.03348587499972685,
                                    'kp_unpaired': 0.009765625,
                                    'kp_gap_px': 0.11535054643075823,
                                    'desc_gap': 0.003819677628079265,
                                    'pairs_missing': 0.0,
                                    'match_extra': 0.006238859180035651,
                                    'match_missing': 0.004808206004915055,
                                    'epi_bad': 0.010596157654981184,
                                    'pose_gain': 4.651736773743412e-05,
                                    'point_gain': 2.7513210212516504e-05}},
 'stress100_tracks.batch': {'sums': {'keypoints': 1694492.398846358,
                                     'kp_mask': 3015.0,
                                     'pose': 56.8563556063898,
                                     'pose_valid': 12.0,
                                     'pose_fixed': 1.0,
                                     'pair_idx': 726.0,
                                     'pair_ok': 66.0,
                                     'match_ij': 4099455.0,
                                     'valid_ij': 13228.0,
                                     'match_ji': 1670074.0,
                                     'valid_ji': 13228.0,
                                     'points': 4781.496235914994,
                                     'lm_valid': 253.0,
                                     'lm_two_view': 195.0,
                                     'n_landmarks': 501.0,
                                     'kp2lm': 939511.0,
                                     'intr': 1760.3311767578125,
                                     'xy': 1694492.398846358,
                                     'desc': 21.626289258759925,
                                     'mask': 3015.0},
                            'program': {'unregistered': 0.0,
                                        'ate': 0.0015241303361665755,
                                        'pairs_missing': 0.0,
                                        'match_extra': 0.0,
                                        'match_missing': 0.0,
                                        'epi_bad': 0.0,
                                        'pose_gain': 1.7833942215643383e-10,
                                        'point_gain': 2.659822901824679e-09},
                            'control': {'unregistered': 0.0,
                                        'ate': 0.0015241303361665755,
                                        'pairs_missing': 0.0,
                                        'match_extra': 0.026565604533078224,
                                        'match_missing': 0.0,
                                        'epi_bad': 0.02627124880417985,
                                        'pose_gain': 0.00164984342010221,
                                        'point_gain': 0.014471250466890639}}}


def add_tracks_cell(here: Path) -> str:
    bench_path = here.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "stress100_tracks", "source": "https://example.org",
                             "file": "sfmbench/configs/stress100_tracks.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "stress100_tracks.batch", "config": "stress100_tracks",
                               "traffic": "batch", "chips": 1, "why": "test"})
    bench_path.write_text(json.dumps(bench))
    return "stress100_tracks.batch"


def output_sums(out: dict) -> dict:
    sums = {k: float(v.double().sum()) for k, v in out["scene"].items() if torch.is_tensor(v)}
    sums.update({k: float(out[k].double().sum()) for k in ("xy", "desc", "mask")})
    return sums


@pytest.mark.parametrize("workload", ["orbit512_dog.batch", "stress100_tracks.batch"])
def test_the_judge_numbers_are_unchanged(here, dog_batch, workload):
    req = (dog_batch if workload == "orbit512_dog.batch"
           else first_request(here, add_tracks_cell(here)))
    frozen, out, c = FROZEN[workload], req["record"]["out"], req["cell"]
    assert output_sums(out) == frozen["sums"], "the program's outputs moved"
    for name, control in (("program", None), ("control", c["config"]["control"])):
        assert judged(c, out, req["truth"], control) == frozen[name], name


# ---- the stated pairs with a ladder --------------------------------------------------

def sequence_pairs(n=40, window=3, retrieval_k=2, ladder=True):
    """``candidate_pairs`` on a sequence whose frames grow less alike with their
    distance, as video frames do: pooled descriptors on a great circle."""
    ang = 0.05 * torch.arange(n, dtype=torch.float32)
    g = torch.zeros(n, 8)
    g[:, 0], g[:, 1] = torch.cos(ang), torch.sin(ang)
    desc = g[:, None, :].expand(n, 4, 8).contiguous()
    mask = torch.ones(n, 4, dtype=torch.bool)
    return torch.as_tensor(candidate_pairs(desc, mask, window, retrieval_k, ladder)).long()


def test_candidate_pairs_with_a_ladder_miss_nothing():
    n, w, k = 40, 3, 2
    pairs = sequence_pairs(n, w, k)
    gap = pairs[:, 1] - pairs[:, 0]
    assert set(gap[gap > w].tolist()) >= {6, 12, 24, w + 1}      # rungs and retrievals
    padded = torch.as_tensor(bucket_pairs(pairs.int().numpy()))
    assert judge_pairs(padded, n, w, k, ladder=True, symmetric=True)["pairs_missing"] == 0
    want, slots = stated_pairs(n, w, k, ladder=True, symmetric=True)
    total = len(want) + int(slots.sum())

    # one ladder pair dropped: one stated pair missing
    rung = int(torch.nonzero(gap == 12)[0, 0])
    fewer = torch.cat([pairs[:rung], pairs[rung + 1:]])
    assert judge_pairs(fewer, n, w, k, ladder=True, symmetric=True)["pairs_missing"] == 1 / total

    # every retrieval pair dropped: every slot empty, the ladder filling none
    ladder_only = pairs[(gap <= w) | torch.isin(gap, torch.tensor([6, 12, 24]))]
    missing = judge_pairs(ladder_only, n, w, k, ladder=True, symmetric=True)["pairs_missing"]
    assert missing == int(slots.sum()) / total
    # where the ladder is not stated, its pairs fill slots and hide the loss
    assert judge_pairs(ladder_only, n, w, k, symmetric=True)["pairs_missing"] < missing


def test_the_closed_loops_retrieval_looks_to_both_sides():
    # candidate_pairs pairs a frame with its most alike frames beyond the window
    # on either side: the stream's rule (earlier frames only) would read slots
    # of a sound list as empty
    n, w, k = 40, 3, 2
    pairs = sequence_pairs(n, w, k)
    assert judge_pairs(pairs, n, w, k, ladder=True)["pairs_missing"] > 0


def test_a_retrieval_pick_at_a_ladder_offset_fills_no_slot():
    # the difference judge_pairs' docstring states: with 4 retrievals beyond a
    # window of 3, frame 0's picks reach the first rung (0, 6), kept as one pair
    n, w, k = 40, 3, 4
    pairs = sequence_pairs(n, w, k)
    assert judge_pairs(pairs, n, w, k, ladder=True, symmetric=True)["pairs_missing"] > 0


def test_without_a_ladder_the_stream_rule_is_unchanged():
    # the stream's stated pairs over 12 frames, window 6, 2 retrievals, as before
    want, slots = stated_pairs(12, 6, 2)
    assert len(want) == sum(min(j, 6) for j in range(12))
    assert slots.tolist() == [0] * 7 + [1] + [2] * 4


# ---- the frontend block states its closed loop's pairs -----------------------------

def test_check_spec_takes_the_frontends_stated_pairs(here):
    rule = {"window": 10, "retrieval_k": 3, "ladder": True}
    workload = add_cell(here, "orbit512_windowed", "dog", pairs=rule)
    spec = harness.check_spec(harness.cell(workload, here=here))
    assert spec["pairs"] == dict(rule, symmetric=True)
    assert harness.check_spec(harness.cell("orbit512_dog.batch", here=here))["pairs"] == {
        "window": 0, "retrieval_k": 0}
    assert harness.check_spec(harness.cell("orbit512_dog.stream", here=here))["pairs"] == {
        "window": 6, "retrieval_k": 2}
    conf_path = here / "configs" / "orbit512_windowed.json"
    conf = json.loads(conf_path.read_text())
    del conf["frontend"]["pairs"]
    conf["options"]["pair_window"] = 10
    conf_path.write_text(json.dumps(conf))
    with pytest.raises(harness.CellError, match="pair_window"):
        harness.check_spec(harness.cell(workload, here=here))
