"""scripts/stress_100.py's recipe at test size through both packages'
``run_sfm`` on the CPU: 24 frames x 256 tracks of its generator (one copy,
``chip_smoke.stress_world``, taken here through the port's script
``scripts/stress_100_torch.py``), world seed 0, and its options
(``STRESS_OPTIONS``: a local BA at every registration, exhaustive pairs).

Readings (on the CPU, world seeds 0-7; the trajectory's extent, the
largest distance of a true camera centre from their mean, is 0.657):

- registered: 24 of 24 in both packages on every seed; equal counts held.
- ATE: 0.00137-0.00175 in either package (seed 0: 0.00170 in both; the
  reference's figure at full size is 0.0016). Limit 0.0025. A port whose
  BAs do not run reads 0.00137-0.00201 (seed 0: 0.00184): at this size the
  ATE alone does not tell it from a sound one.
- the port's camera centres aligned onto the reference's (similarity, RMS
  over the frames both registered, as a fraction of the extent): 3e-5 to
  3.5e-4 (seed 0: 4e-5); the port without BAs 6.5e-4 to 1.65e-3 (seed 0:
  9.8e-4), and a port whose ``refine_ba`` returns its input unchanged 8.6e-4
  on seed 0. Limit 5e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eacham_tpu.sfm import SfmOptions as JaxOptions, run_sfm as jax_run_sfm
from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
from eacham_tpu_torch.utils.evaluate import align_umeyama, trajectory_ate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N_FRAMES, N_PTS, SIZE = 24, 256, (640, 480)
MAX_ATE, MAX_ACROSS = 0.0025, 5e-4


def _script():
    spec = importlib.util.spec_from_file_location(
        "stress_100_torch", ROOT / "scripts" / "stress_100_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    from chip_smoke import STRESS_OPTIONS

    uv, desc, mask, poses, intr = _script().stress_world(N_FRAMES, N_PTS)
    ref, ref_stats = jax_run_sfm(jnp.asarray(uv), jnp.asarray(desc), jnp.asarray(mask),
                                 image_size=SIZE, intr=jnp.asarray(intr),
                                 options=JaxOptions(**STRESS_OPTIONS), verbose=False)
    port, port_stats = run_sfm(uv, desc, mask, SIZE, intr=intr,
                               options=SfmOptions(**STRESS_OPTIONS), device="cpu")
    return ((np.asarray(ref.pose), np.asarray(ref.pose_valid), ref_stats),
            (port.pose.numpy(), port.pose_valid.numpy(), port_stats), poses)


def _centers(poses):
    P = np.asarray(poses, np.float64)
    return -np.einsum("nij,ni->nj", P[:, :3, :3], P[:, :3, 3])


def test_the_generator_and_options_are_the_reference_scripts(monkeypatch):
    """scripts/stress_100.py's own ``main`` run up to its first ``run_sfm``
    call (stubbed): the same arrays bit for bit, the same intrinsics and
    options."""
    import eacham_tpu.sfm as jax_sfm
    from chip_smoke import STRESS_OPTIONS

    class Stop(Exception):
        pass

    seen = {}

    def stub(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise Stop

    monkeypatch.setattr(jax_sfm, "run_sfm", stub)
    spec = importlib.util.spec_from_file_location("stress_100", ROOT / "scripts" / "stress_100.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    with pytest.raises(Stop):
        ref.main()
    uv, desc, mask, _, intr = _script().stress_world()
    for a, b in zip(seen["args"], (uv, desc, mask)):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(seen["kwargs"]["intr"]), intr)
    assert seen["kwargs"]["image_size"] == SIZE
    assert seen["kwargs"]["options"] == JaxOptions(**STRESS_OPTIONS)


def test_both_register_every_frame(runs):
    (_, _, ref_stats), (_, _, port_stats), _ = runs
    assert ref_stats["registered"] == port_stats["registered"] == N_FRAMES


@pytest.mark.parametrize("package", ["reference", "port"])
def test_ate(runs, package):
    pose, valid, _ = runs[0] if package == "reference" else runs[1]
    ate = trajectory_ate(pose[valid], runs[2][valid])
    assert ate < MAX_ATE, ate


def test_port_centres_aligned_onto_the_reference(runs):
    (ref, ref_valid, _), (port, port_valid, _), poses = runs
    both = ref_valid & port_valid
    a, b = _centers(port)[both], _centers(ref)[both]
    s, R, t = align_umeyama(a, b)
    rms = np.sqrt((((s * (R @ a.T)).T + t - b) ** 2).sum(1).mean())
    truth = _centers(poses)
    extent = np.linalg.norm(truth - truth.mean(0), axis=1).max()
    assert rms / extent < MAX_ACROSS, rms / extent
