"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (on the CPU at a small size, the look for a
card skipped): a step that returns its state unchanged (every bundle
adjustment hands back its input, or hands back its input's landmarks with
refined poses), half of the batch left out (half of the frames' keypoints
masked off where the program makes or takes them, or every other
candidate pair dropped where the program makes its pair list), and an
answer altered where it is produced (kernel 1's matches moved to the next
keypoint). One card runs these cells, so no exchange between cards can be
left out."""

import pytest
import torch

import eacham_tpu_torch.ba.core as core
import eacham_tpu_torch.ops.match_kernel as mk
import eacham_tpu_torch.parallel.ba as pba
import eacham_tpu_torch.sfm.device_loop as dl
import eacham_tpu_torch.sfm.pipeline as pl
from sfmbench import run
from sfmbench_tiny import tiny_copy

CELLS = ["orbit512_dog.batch", "orbit512_dog.stream"]


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def ba_unchanged(monkeypatch):
    def refine_ba(p, cfg=core.BAConfig(), group=None):
        return p.poses, p.points, p.intr, {"iterations": 0, "initial_cost": torch.zeros(()),
                                           "final_cost": torch.zeros(()), "converged": True}

    for mod in (core, pba, dl):
        monkeypatch.setattr(mod, "refine_ba", refine_ba)


def ba_points_unchanged(monkeypatch):
    orig = core.refine_ba

    def refine_ba(p, cfg=core.BAConfig(), group=None):
        poses, _, intr, stats = orig(p, cfg, group)
        return poses, p.points, intr, stats

    for mod in (core, pba, dl):
        monkeypatch.setattr(mod, "refine_ba", refine_ba)


def half_the_pairs(monkeypatch):
    import eacham_tpu_torch.sfm.matches as sm
    import eacham_tpu_torch.sfm.streaming as st

    orig_all = sm.all_pairs_index
    monkeypatch.setattr(sm, "all_pairs_index", lambda n: orig_all(n)[::2])
    orig_new = st.StreamingReconstructor._new_pairs
    monkeypatch.setattr(st.StreamingReconstructor, "_new_pairs",
                        lambda self, first, last: orig_new(self, first, last)[::2])


def half_the_frames(monkeypatch):
    import eacham_tpu_torch.features.frontend as fe
    import eacham_tpu_torch.sfm.streaming as st

    def cut(mask):
        mask = mask.clone()
        mask[1::2] = False
        return mask

    orig_extract = fe.extract_features

    def extract(*a, **k):
        xy, desc, score, mask = orig_extract(*a, **k)
        return xy, desc, score, cut(mask)

    monkeypatch.setattr(fe, "extract_features", extract)
    monkeypatch.setattr(st, "extract_features", extract)
    orig_run = pl.run_sfm

    def run_sfm(kps, desc, mask, *a, **k):
        return orig_run(kps, desc, cut(torch.as_tensor(mask)), *a, **k)

    monkeypatch.setattr(pl, "run_sfm", run_sfm)


def matches_altered(monkeypatch):
    orig = mk.decide

    def decide(raw, mask, pair_idx, ratio):
        j, valid = orig(raw, mask, pair_idx, ratio)
        return torch.where(valid, (j + 1) % j.shape[1], j), valid

    monkeypatch.setattr(mk, "decide", decide)


@pytest.mark.parametrize("fault", [ba_unchanged, ba_points_unchanged, half_the_frames,
                                   half_the_pairs, matches_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_is_not_correct(here, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run.run(workload, 21, 0.1, False, device=torch.device("cpu"), here=here)
    assert res["correct"] is False, res["checks"]
