"""The frozen copies of the recipes that make the inputs equal the
program's and chip_smoke.py's, array for array and bit for bit."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE.parent))

import chip_smoke  # noqa: E402
from eacham_tpu_torch.utils import synthetic  # noqa: E402

from sfmbench import harness  # noqa: E402
from sfmbench.inputs import orbit_blobs, stress_tracks  # noqa: E402


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_blob_field_and_poses_equal_the_programs():
    for textured in (False, True):
        a = orbit_blobs.make_blob_scene(np.random.default_rng(3), 50, textured=textured)
        b = synthetic.make_blob_scene(np.random.default_rng(3), 50, textured=textured)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(orbit_blobs.orbit_poses(100, 0.6, 0.5, 0.03),
                                  synthetic.orbit_poses(100, 0.6, 0.5, 0.03))


@pytest.mark.parametrize("textured", [False, True])
def test_render_equals_the_programs(textured):
    scene = synthetic.make_blob_scene(np.random.default_rng(5), 300, textured=textured)
    intr = np.array([300.0, 300.0, 96.0, 64.0], np.float32)
    for T in synthetic.orbit_poses(3):
        np.testing.assert_array_equal(orbit_blobs.render_view(scene, T, intr, 192, 128),
                                      synthetic.render_view(scene, T, intr, 192, 128))


def test_the_bench_workload_at_seed_0_is_chip_smokes():
    ours = harness.make_inputs(config("orbit512_dog"))
    images, poses, intr = chip_smoke.render_workload()
    np.testing.assert_array_equal(ours["images"], images)
    np.testing.assert_array_equal(ours["poses"], poses)
    np.testing.assert_array_equal(ours["intr"], intr)


def test_stress_world_equals_chip_smokes():
    ours = harness.make_inputs(config("stress100_tracks"))
    for k, theirs in zip(("keypoints", "descriptors", "mask", "poses", "intr"),
                         chip_smoke.stress_world()):
        np.testing.assert_array_equal(ours[k], theirs)
    for seed in (0, 7):
        for a, b in zip(stress_tracks.stress_world(100, 1024, seed),
                        chip_smoke.stress_world(100, 1024, seed)):
            np.testing.assert_array_equal(a, b)


def test_options_are_the_recipes():
    from eacham_tpu_torch.sfm.pipeline import SfmOptions

    orbit, stress = config("orbit512_dog"), config("stress100_tracks")
    o = dict(orbit["options"])
    assert o.pop("max_features") == orbit["frontend"]["max_keypoints"] == chip_smoke.MAX_KPS
    assert o == chip_smoke.BENCH_OPTIONS
    assert stress["options"] == chip_smoke.STRESS_OPTIONS
    assert orbit["frontend"]["max_keypoints"] == chip_smoke.MAX_KPS
    stream = json.loads((HERE / "traffic" / "stream.json").read_text())
    assert {k: stream[k] for k in chip_smoke.STREAM} == chip_smoke.STREAM
    assert stream["chunk"] == chip_smoke.STREAM_CHUNK
    assert stream["stream_frames"] == chip_smoke.N_FRAMES
    # the reference's matching rule is the run's
    for c in (orbit, stress):
        opts = SfmOptions(**c["options"])
        assert c["check"]["match_ratio"] == opts.match_ratio
        assert c["check"]["min_matches"] == opts.min_matches
    assert stress["guarantees"]["max_ate"] == chip_smoke.STRESS_MAX_ATE
    assert stress["guarantees"]["min_registered"] == chip_smoke.STRESS_MIN_REGISTERED
