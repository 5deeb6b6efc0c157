"""The anchored path, ``resume_sfm(abs_anchors=...)``, held against the JAX
package on the CPU: scripts/anchor_probe.py's sequence at test size.

The JAX package runs ``run_sfm`` with windowed candidate pairs on a small
track world and writes the scene with its ``save_scene``; both packages
``load_scene`` that file, express the ground truth of five frames spread
evenly over the registered ones in the estimate's frame with their own
``anchors_in_estimate_frame``, and re-finalize with ``resume_sfm(...,
abs_anchors=...)`` (every global BA then carries the absolute se(3) priors
and releases the init-pair gauge freeze).

The world has to drift for the anchors to matter: 24 frames sideways along
a slow turn past a strip of 500 points, each seen in a few frames, at 2 px
of noise. The relative measurements leave a smooth warp of a few percent of
the extent that the global BAs do not remove (the 1000-frame recipe's
finding, at test size), and the similarity that carries the truth into the
estimate's frame is fitted to the drifted centres, so the anchors' own
rotations sit degrees away from the scene's. At 2 px the reference's own
``run_sfm`` is fragile on this world: seeds 0, 1, 3, 6, 7 and 9 register
12-23 of 24 frames (seeds 3 and 6 at ATE 0.9-1.1); 2, 4, 5, 8, 10 and 11
register all 24 and are the sound runs. Seed 5 is the test's: of the sound
seeds it puts the mutant furthest from the limits. Readings (on the CPU),
as fractions of the trajectory's extent (the largest distance of a
ground-truth centre from their mean) or in degrees:

- the two anchored scenes against each other (same checkpoint, same
  anchors): centres 3.2e-6 and rotations 1.2e-4 deg on seed 5, at most
  2.3e-3 and 0.082 deg over seeds 1, 2, 4, 5 and 8-11; the port resumed
  without anchors against the reference's anchored scene reads 0.0723 and
  15.79 deg on seed 5. Limits 0.01 and 0.5 deg.
- each package's unaligned centre error in the anchor frame (the largest
  over the registered frames, against the ground truth carried into the
  estimate's frame by the anchors' similarity), as
  tests/test_pipeline.py's anchors test does in the truth's frame: 0.0174
  in both packages on seed 5, at most 0.0343 over the sound seeds; the port
  without anchors 0.0737 on seed 5. Limit 0.05.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import rotation_deg
from eacham_tpu.io.checkpoint import save_scene as jax_save_scene
from eacham_tpu.sfm import SfmOptions as JaxOptions
from eacham_tpu.sfm import anchors_in_estimate_frame as jax_anchors
from eacham_tpu.sfm import resume_sfm as jax_resume_sfm, run_sfm as jax_run_sfm
from eacham_tpu_torch.io.checkpoint import load_scene
from eacham_tpu_torch.sfm import anchors_in_estimate_frame, resume_sfm
from eacham_tpu_torch.sfm.pipeline import SfmOptions

torch.set_num_threads(2)

N_FRAMES, N_PTS, SIZE, SEED = 24, 500, (320, 240), 5
N_ANCHORS = 5
# the phase's options scaled to the size: windowed and retrieval pairs, a
# local BA window with frozen cameras beyond the free span, interim BAs,
# the anchors' sigmas (chip_smoke.ANCHOR_OPTIONS: 0.05, 0.005)
OPTS = dict(min_initial_inliers=30, min_matches=16, init_min_tri_angle_deg=0.5,
            min_tri_angle_deg=0.5, ransac_hyps_e=64, ransac_hyps_h=32, ransac_hyps_pnp=64,
            lm_capacity=4096, refine_max_iters=5, global_max_iters=12, local_ba_max_iters=4,
            local_ba_every=2, sweep_segment=8, interim_ba_iters=3, pair_window=3,
            pair_retrieval_k=2, local_ba_free_span=2, abs_sigma_pos=0.05, abs_sigma_rot=0.005)
MAX_ACROSS_CENTER, MAX_ACROSS_ROT_DEG, MAX_CENTER_ERR = 0.01, 0.5, 0.05


def drift_world(seed=SEED):
    """A camera moving sideways on a slow turn (0.3 a frame, 0.02 rad a
    frame) past 500 points at depth 3-6, f = 400 at 320x240 (each point
    in view for a few frames), 2 px of pixel noise; keypoint slot k of
    every frame is point k with noisy per-frame views of its descriptor."""
    rng = np.random.default_rng(seed)
    step, f = 0.3, 400.0
    pts = np.stack([rng.uniform(-2, step * N_FRAMES + 2, N_PTS), rng.uniform(-1.2, 1.2, N_PTS),
                    rng.uniform(3.0, 6.0, N_PTS)], 1).astype(np.float32)
    intr = np.array([f, f, SIZE[0] / 2, SIZE[1] / 2], np.float32)
    Ts = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    for i in range(N_FRAMES):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        Ts[i, :3, :3] = R
        Ts[i, :3, 3] = -R @ np.array([step * i, 0.02 * np.sin(i), 0.0], np.float32)
    pc = np.einsum("nij,pj->npi", Ts[:, :3, :3], pts) + Ts[:, None, :3, 3]
    uv = np.stack([f * pc[..., 0] / pc[..., 2] + intr[2],
                   f * pc[..., 1] / pc[..., 2] + intr[3]], -1)
    uv = (uv + rng.normal(scale=2.0, size=uv.shape)).astype(np.float32)
    vis = ((pc[..., 2] > 0.1) & (uv[..., 0] > 0) & (uv[..., 0] < SIZE[0])
           & (uv[..., 1] > 0) & (uv[..., 1] < SIZE[1]))
    dsc = rng.normal(size=(N_PTS, 256)).astype(np.float32)
    dsc = dsc[None] + rng.normal(scale=0.03, size=(N_FRAMES, N_PTS, 256)).astype(np.float32)
    dsc /= np.linalg.norm(dsc, axis=-1, keepdims=True)
    return uv, dsc, vis, intr, Ts


def centers(poses):
    P = np.asarray(poses, np.float64)
    return -np.einsum("nij,ni->nj", P[:, :3, :3], P[:, :3, 3])


def anchor_ids(valid):
    """scripts/anchor_probe.py:146-148: evenly over the registered frames."""
    reg = np.flatnonzero(valid)
    return reg[np.linspace(0, len(reg) - 1, N_ANCHORS).round().astype(int)]


def resume_both(path, Ts, port_anchors=True):
    """Both packages load ``path``, anchor five frames with their own
    ``anchors_in_estimate_frame`` and resume. Returns (reference poses,
    port poses, registered mask, ground truth in the estimate's frame)."""
    from eacham_tpu.io.checkpoint import load_scene as jax_load_scene

    js, _ = jax_load_scene(path)
    valid = np.asarray(js.pose_valid)
    ids = anchor_ids(valid)
    a_j, m_j = jax_anchors(np.asarray(js.pose), Ts, ids, valid=valid)
    j2, _ = jax_resume_sfm(js, options=JaxOptions(**OPTS), verbose=False,
                           abs_anchors=(jnp.asarray(a_j), jnp.asarray(m_j)))
    ts, _ = load_scene(path, device="cpu")
    a_t, m_t = anchors_in_estimate_frame(ts.pose, Ts, ids, valid=ts.pose_valid)
    np.testing.assert_array_equal(m_t, m_j)
    t2, _ = resume_sfm(ts, options=SfmOptions(**OPTS), verbose=False,
                       abs_anchors=(a_t, m_t) if port_anchors else None, device="cpu")
    # the whole ground truth in the estimate's frame: anchors on every frame
    truth, _ = jax_anchors(np.asarray(js.pose), Ts, np.arange(N_FRAMES), valid=valid)
    return np.asarray(j2.pose), t2.pose.numpy(), valid, truth


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    uv, dsc, vis, intr, Ts = drift_world()
    scene, stats = jax_run_sfm(jnp.asarray(uv), jnp.asarray(dsc), jnp.asarray(vis),
                               image_size=SIZE, intr=jnp.asarray(intr),
                               options=JaxOptions(**OPTS), verbose=False)
    assert stats["registered"] == N_FRAMES
    path = tmp_path_factory.mktemp("anchors") / "scene.npz"
    jax_save_scene(path, scene)
    return resume_both(path, Ts)


def extent(truth, valid):
    c = centers(truth)[valid]
    return float(np.linalg.norm(c - c.mean(0), axis=1).max())


def test_anchored_scenes_agree_across_packages(resumed):
    ref, port, valid, truth = resumed
    ext = extent(truth, valid)
    across = np.linalg.norm(centers(ref) - centers(port), axis=1)[valid].max() / ext
    rot = rotation_deg(ref, port)[valid].max()
    assert across < MAX_ACROSS_CENTER and rot < MAX_ACROSS_ROT_DEG, (across, rot)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_anchored_scene_sits_in_the_anchor_frame(resumed, package):
    ref, port, valid, truth = resumed
    pose = ref if package == "reference" else port
    err = np.linalg.norm(centers(pose) - centers(truth), axis=1)[valid].max() / extent(truth, valid)
    assert err < MAX_CENTER_ERR, err
