"""The deep path to its end, on the CPU at a small size: the JAX package's
deep match graph (``build_match_tables_deep``'s 6-tuple: windowed and
retrieval pairs, epipolar-verified) handed to both packages' ``run_sfm``
with ``scripts/bench_deep.py``'s options scaled down (a local BA every 3rd
registration), and the port's own chain ``extract_deep_batch ->
build_match_tables_deep -> run_sfm`` run twice, held to equal bits.

12 frames at 256x192, K = 256, window 4, retrieval 2, the shipped weights.

Seeds. The two packages draw their RANSAC hypotheses from different
generators (threefry against torch's). At this size one run's outcome
depends on its draws in either package: the two-view stage's good-point
count on one pair moves between 0 and 101 from one seed to the next, and a
run's ATE between 5% and 43% of the trajectory's extent. So both packages
run on the same seeds 0-7, one seed driving both runs of each pair, and
what is compared is what the eight runs show together.

The init pair. Both packages rank the pairs alike (equal orders), and each
takes the same pair, (0, 4), on most seeds; on the others it takes (2, 7),
(0, 5) or (0, 3) by its draws. The per-seed pairs of both packages are in
PERF.md section 7. The test requires the same most frequent pair in both,
taken on at least half of the seeds.

Limits. Each limit lies between the largest reading of the sound runs
(both packages, seeds 0-7 and 8-15) and the smallest reading of a port
whose bundle adjustment is removed (no local and no global BA), on these
tables:

- median over the seeds of each package's ATE (camera centres after a
  similarity alignment, as scripts/bench_deep.py measures it) over the
  extent: sound at most 0.149, no BA at least 0.291; limit 0.2;
- median over the seeds of the worst error of the rotation between two
  consecutive cameras against the truth (gauge-free): sound at most 1.553
  deg, no BA at least 3.054; limit 2.2 deg. The cameras are 2 deg apart;
  a limit at a small fraction of that would fail the JAX package itself,
  whose worst pair reads 0.52-2.29 deg over the sixteen seeds;
- the port against the JAX package on the same seed, median over the
  seeds: the RMS of the port's camera centres after a similarity alignment
  onto the JAX package's, over the extent (sound at most 0.312, no BA at
  least 0.590; limit 0.45), and the worst difference of the consecutive
  rotations (sound at most 1.518 deg, no BA at least 3.445; limit 2.2 deg).

Removing only the global BA moves none of these past the JAX package's own
spread at this size (worst rotation median 1.334 deg against the JAX
package's 1.553), so the port's global BA is held by its statistics: it
ran on every seed and lowered its cost. The two BAs also differ by design
in the point prior's block (ROADMAP section 3), which moves the focal
lengths of the local BAs apart on the same problem.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eacham_tpu.features.deep import frontend as jfe
from eacham_tpu.sfm import pipeline as jpipe
from eacham_tpu.sfm.scene import make_scene as jax_make_scene
from eacham_tpu.utils.synthetic import render_sequence
from eacham_tpu_torch.features.deep import frontend as tfe
from eacham_tpu_torch.sfm import pipeline as tpipe
from eacham_tpu_torch.sfm.scene import make_scene
from eacham_tpu_torch.utils.evaluate import trajectory_ate

torch.set_num_threads(2)

N, W, H, K = 12, 256, 192, 256
WINDOW, RETRIEVAL, THRESHOLD, VERIFY_SEED = 4, 2, 0.15, 7
# scripts/bench_deep.py:76-85, the initial inliers, the match floor and the
# landmark capacity scaled to 12 frames of 256 keypoints
OPTS = dict(min_initial_inliers=30, min_matches=15, match_ratio=0.85,
            init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
            ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
            lm_capacity=2048, refine_max_iters=30, global_max_iters=50,
            local_ba_every=3)
SEEDS = 8
ATE_LIMIT, ROT_LIMIT_DEG = 0.2, 2.2
CROSS_ATE_LIMIT, CROSS_ROT_LIMIT_DEG = 0.45, 2.2


@pytest.fixture(scope="module")
def world():
    images, poses, intr = render_sequence(np.random.default_rng(3), n_frames=N, width=W,
                                          height=H)
    return images.astype(np.float32), poses, np.asarray(intr, np.float32)


def _centres(T):
    T = np.asarray(T, np.float64)
    return -np.einsum("nij,ni->nj", T[:, :3, :3], T[:, :3, 3])


def _extent(poses):
    c = _centres(poses)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max())


def _relative_rotations(pose):
    """Rotations between consecutive cameras (gauge-free), [M - 1, 3, 3]."""
    R = np.asarray(pose, np.float64)[:, :3, :3]
    return np.einsum("nij,nkj->nik", R[1:], R[:-1])


def _worst_rotation_deg(pose_a, pose_b):
    """The largest angle between the two trajectories' consecutive rotations."""
    Ra, Rb = _relative_rotations(pose_a), _relative_rotations(pose_b)
    c = (np.trace(np.einsum("nij,nkj->nik", Ra, Rb), axis1=1, axis2=2) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))).max())


@pytest.fixture(scope="module")
def reference(world):
    """The JAX package's features and 6-tuple."""
    images, _, intr = world
    sp_params, lg_params, n_layers = jfe.load_frontend_params()
    opt = jpipe.SfmOptions(**OPTS)
    xy, desc, _, mask = jfe.extract_deep_batch(sp_params, jnp.asarray(images), max_keypoints=K)
    tables = jfe.build_match_tables_deep(
        lg_params, xy, desc, mask, (W, H), n_layers=n_layers, min_matches=opt.min_matches,
        pair_window=WINDOW, retrieval_k=RETRIEVAL, threshold=THRESHOLD,
        verify=(jnp.asarray(intr), jax.random.PRNGKey(VERIFY_SEED), opt.max_repr_error,
                opt.verify_hyps))
    # copies: arrays viewed from JAX buffers are read-only, which torch warns about
    return dict(xy=np.array(xy), mask=np.array(mask), tables=[np.array(t) for t in tables])


def _rank_orders(reference, world):
    """Both packages' rank order of the candidate init pairs."""
    _, _, intr = world
    cap = OPTS["lm_capacity"]
    jscene = jax_make_scene(jnp.asarray(reference["xy"]), jnp.asarray(reference["mask"]),
                            *(jnp.asarray(t) for t in reference["tables"]), jnp.asarray(intr),
                            lm_capacity=cap)
    tscene = make_scene(torch.as_tensor(reference["xy"]), torch.as_tensor(reference["mask"]),
                        *(torch.as_tensor(t) for t in reference["tables"]),
                        torch.as_tensor(intr), lm_capacity=cap)
    orders = []
    for score in (np.asarray(jpipe.rank_init_pairs(jscene, float(W))),
                  tpipe.rank_init_pairs(tscene, float(W)).numpy()):
        order = np.argsort(-score, kind="stable")
        orders.append(order[score[order] > 0])
    return orders


@pytest.fixture(scope="module")
def runs(reference, world):
    """Both packages' ``run_sfm`` on the reference's 6-tuple, seeds
    0..SEEDS-1, the same seed for both runs of a pair."""
    _, _, intr = world
    N_, K_ = reference["mask"].shape
    out = {"jax": [], "torch": []}
    for seed in range(SEEDS):
        jscene, jstats = jpipe.run_sfm(
            jnp.asarray(reference["xy"]), jnp.zeros((N_, K_, 1), jnp.float32),
            jnp.asarray(reference["mask"]), image_size=(W, H), intr=jnp.asarray(intr),
            options=jpipe.SfmOptions(seed=seed, **OPTS), verbose=False,
            match_tables=tuple(jnp.asarray(t) for t in reference["tables"]))
        out["jax"].append((np.array(jscene.pose), np.array(jscene.pose_valid), jstats))
        tscene, tstats = tpipe.run_sfm(
            reference["xy"], np.zeros((N_, K_, 1), np.float32), reference["mask"], (W, H),
            intr=intr, options=tpipe.SfmOptions(seed=seed, **OPTS),
            match_tables=tuple(reference["tables"]), device="cpu")
        out["torch"].append((tscene.pose.numpy(), tscene.pose_valid.numpy(), tstats))
    out["orders"] = _rank_orders(reference, world)
    return out


def test_init_pair_on_the_reference_deep_tables(runs):
    """Both packages rank the windowed and retrieval pairs alike, and take
    the same pair most often over the seeds, on at least half of them."""
    pairs = {k: [tuple(int(v) for v in r[2]["init_pair"]) for r in runs[k]]
             for k in ("jax", "torch")}
    print(f"init pairs over seeds 0-{SEEDS - 1}: {pairs}")
    np.testing.assert_array_equal(runs["orders"][0], runs["orders"][1])
    (pair_j, n_j), (pair_t, n_t) = (Counter(pairs[k]).most_common(1)[0] for k in pairs)
    assert pair_j == pair_t, pairs
    assert 2 * n_j >= SEEDS and 2 * n_t >= SEEDS, pairs


def test_run_sfm_on_the_reference_deep_tables(reference, runs, world):
    """Same 6-tuple and seed in: the same registered frames on every seed;
    over the seeds, each package's poses near the truth and the port's near
    the JAX package's after alignment, within the limits above; the port's
    global BA ran on every seed and lowered its cost."""
    _, poses, _ = world
    extent = _extent(poses)
    ate, rot, cross_ate, cross_rot = {"jax": [], "torch": []}, {"jax": [], "torch": []}, [], []
    for (pose_ref, valid_ref, ref), (pose, valid, stats) in zip(runs["jax"], runs["torch"]):
        assert stats["pairs"] == reference["tables"][0].shape[0] < N * (N - 1) // 2 + 64
        np.testing.assert_array_equal(valid, valid_ref)
        assert stats["registered"] == ref["registered"] == N
        gba = stats["global_ba"]
        assert gba is not None and gba["iterations"] > 0
        assert gba["final_cost"] < gba["initial_cost"], gba
        for k, p in (("jax", pose_ref[valid]), ("torch", pose[valid])):
            ate[k].append(trajectory_ate(p, poses[valid]) / extent)
            rot[k].append(_worst_rotation_deg(p, poses[valid]))
        cross_ate.append(trajectory_ate(pose[valid], pose_ref[valid]) / extent)
        cross_rot.append(_worst_rotation_deg(pose[valid], pose_ref[valid]))
    med = {name: {k: float(np.median(v[k])) for k in v} for name, v in
           (("ate", ate), ("rot", rot))}
    cross = float(np.median(cross_ate)), float(np.median(cross_rot))
    print(f"over seeds 0-{SEEDS - 1}: ATE / extent {ate}, worst consecutive rotation (deg) "
          f"{rot}, port onto reference: centres / extent {cross_ate}, rotation {cross_rot}; "
          f"medians {med}, {cross}")
    for k in ("jax", "torch"):
        assert med["ate"][k] < ATE_LIMIT, med
        assert med["rot"][k] < ROT_LIMIT_DEG, med
    assert cross[0] < CROSS_ATE_LIMIT and cross[1] < CROSS_ROT_LIMIT_DEG, cross


def _port_chain(world, models):
    images, _, intr = world
    opt = tpipe.SfmOptions(**OPTS)
    xy, desc, _, mask = tfe.extract_deep_batch(models[0], images, max_keypoints=K, device="cpu")
    tables = tfe.build_match_tables_deep(
        models[1], xy, desc, mask, (W, H), min_matches=opt.min_matches, pair_window=WINDOW,
        retrieval_k=RETRIEVAL, threshold=THRESHOLD, device="cpu",
        verify=(intr, torch.Generator().manual_seed(VERIFY_SEED), opt.max_repr_error,
                opt.verify_hyps))
    scene, stats = tpipe.run_sfm(xy, desc, mask, (W, H), intr=intr, options=opt,
                                 match_tables=tables, device="cpu")
    return (xy, desc, mask, *tables), scene, stats


def test_the_port_chain_repeats_bit_for_bit(world):
    """``extract_deep_batch -> build_match_tables_deep -> run_sfm`` twice on
    the same frames: equal features, tables, scenes and statistics, and a
    finished reconstruction whose global BA lowered its cost. One run's
    accuracy is not held here: a single run's ATE depends on its draws
    (see above), and the test before holds it over eight."""
    superpoint, matcher, _ = tfe.load_frontend_params(device="cpu")
    front_a, scene_a, stats_a = _port_chain(world, (superpoint, matcher))
    front_b, scene_b, stats_b = _port_chain(world, (superpoint, matcher))
    for a, b in zip(front_a, front_b):
        assert torch.equal(a, b)
    for name in scene_a._fields:
        a, b = getattr(scene_a, name), getattr(scene_b, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name
    for k in ("registered", "landmarks", "init_pair", "n_good", "global_ba"):
        assert stats_a[k] == stats_b[k], k
    gba = stats_a["global_ba"]
    assert stats_a["registered"] == N and gba is not None
    assert gba["final_cost"] < gba["initial_cost"], gba
