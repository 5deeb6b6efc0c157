#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eacham_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--dump tables.npz] [--dump-deep tables_deep.npz]
                          [--dump-deep-world W ...] [--dump-loop loop.npz]

1. prints the card's name and power limit;
2. builds every CUDA kernel of the port from ``eacham_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. renders the 100-frame bench workload (512x384, seed 0) with the port's
   own ``utils/synthetic.py`` and drives four paths through the port's
   entry points, each with the kernel launch counts set to 0 just before
   and read just after:
   - the classical front half at full size: ``extract_features(K=512)`` ->
     ``initialize_sfm`` with the bench's options (``match_pairs`` kernel);
   - the whole classical path at the bench's size and options, twice
     (first and steady): ``extract_features`` -> ``run_sfm`` (match graph
     with the ``match_pairs`` kernel, one launch a run -> init pair ->
     registration sweep with PnP, triangulation and windowed local BA ->
     pruning and global BA). Each run prints one JSON line (stage seconds,
     registered frames, landmarks, ATE, init pair, global BA, a sha256
     ``digest`` of its poses and points) and must pass the bench's gate: at
     least 95 of 100 frames registered, ATE < 0.1; the second run must
     repeat the first bit for bit (poses, points, ``pose_valid``,
     ``lm_valid``, ``kp2lm``, registered, landmarks, the global BA's
     iterations and final cost: ``"repeat_equal": true``);
   - the deep path at full size (scripts/bench_deep.py's workload): the
     shipped weights, ``extract_deep_batch(K=1024)`` ->
     ``build_match_tables_deep(pair_window=10, retrieval_k=3, threshold
     0.15, epipolar verification)`` -> ``initialize_sfm(match_tables=...)``
     (``masked_attention`` kernel, 12 launches per chunk of pairs);
   - the single-pair entry point ``ops.match_pair_fused`` on frames 0 and 1
     of the deep features (``match_pair`` kernel; nothing in the pipeline
     calls it, in the reference either);
4. holds each kernel against its plain PyTorch version on the inputs its
   path gave it, plus the ragged and fully masked cases (the batched
   matcher's and the attention's comparisons three times over, with equal
   results required), and times kernel, plain version, bound and, where
   one PyTorch call computes the same function, that call; for the batched
   matcher also the first launch after the L2 was overwritten (``cold_ms``:
   its path launches it once, on descriptors written long before), for the
   attention also the cross block and the ragged shape; the single-pair
   matcher also on exact inputs at 1024 x 1024, 1000 x 777, with all and
   with all but one keypoint dead (equal bits required, three runs each),
   its kernel launches per call counted under the profiler, and its time
   on the card alone beside the time of a call;
5. checks each path: every kernel of the path launched, edges survive, and
   the init pair's relative pose against ground truth: within 1 deg
   rotation and 5 deg translation direction on the classical path (20 deg
   where the homography path was taken, see MAX_TRANS_DEG_H), 2 and 30 deg
   on the deep path (see DEEP_MAX_ROT_DEG);
6. drives the product's own paths, each printing one JSON line with a
   ``"phase"`` key, its stage seconds, the card and the ``digest`` of the
   reconstruction it ends with (for the CLI: of ``transform.json`` and
   ``cloud.ply``), and each held to the bench's gate (at least 95 of 100
   frames, ATE < 0.1) unless it says otherwise:
   - ``resume``: the second ``run_sfm`` run's scene with frames 50-99 taken
     out -> ``save_scene`` / ``load_scene`` -> ``resume_sfm(finalize=False)``
     with a checkpoint every segment of 16 (at least three written) -> the
     last checkpoint loaded and resumed with ``finalize=True``, which must
     register the frames that the sweep registered;
   - ``cli``: the 100 frames written as 8-bit PGM under
     ``chiprun_out/cli/images`` with a config in the reference's schema,
     then ``eacham_tpu_torch.cli.main`` in this process: transform.json,
     transforms_nerf.json (= inv(pose) @ diag(1, -1, -1, 1)), cloud.ply and
     trajectory.ply (their headers' counts), one ``match_pairs`` launch, the
     decoder that read the frames and the CLI's stage timer;
   - ``stream``: ``StreamingReconstructor(max_frames=100, K=512, window=6,
     retrieval_k=2, finalize_every=5)`` over windows of 10, checkpointed and
     restored into a new object after window 5, ``finalize()`` at the end:
     one ``match_pairs`` launch and no unarrived frame registered in every
     window; the matcher is then held against its plain version on window
     5's own inputs (the capacity table with the unarrived rows masked and
     that window's pairs, not bucketed), three runs with equal bits;
   - ``cli_deep``: the CLI with ``--frontend deep`` on the first 24 frames
     (all 276 pairs), held to DEEP_CLI_MIN_REGISTERED and DEEP_CLI_MAX_ATE,
     with every attention launch counted;
   - ``deep_sfm`` (right after the deep path's checks, before ``cli_deep``):
     scripts/bench_deep.py's recipe to its end on its five blob worlds
     (seeds 0-4; worlds 1-4 rendered by a pool of processes, untimed), each
     through the deep front half and ``run_sfm(match_tables=...)`` with
     DEEP_OPTIONS, world 0 twice. One JSON line: per world the stage
     seconds, registered frames, landmarks, ATE, the init pair and its pose
     error, the global BA, the attention launches and the ``digest``; the
     median ATE. Gate (bench_deep.py:172-174): every world at least 95 of
     100 registered, median ATE < 0.1; exactly ceil(P / 32) * 4 * n_layers
     attention launches and no ``match_pairs`` launch a world; world 0's
     repeat equal bit for bit (features, tables, scene); kernel 3 against
     its plain version on world 0's first chunk. Before it,
     ``match_images_e2e`` on frames 0 and 1: 4 * n_layers attention
     launches, the same matches as ``match_all_pairs_deep`` on that pair;
7. drives the long-trajectory path at scripts/anchor_probe.py's recipe
   (``anchors``, the eleventh slice; it replaces the sixth slice's 500-frame
   ``loop`` phase, whose checks it runs): 1000 frames of the surface world
   on the stress orbit, rendered by a pool of processes,
   ``extract_features(K=1024)`` in chunks of 500 -> ``run_sfm`` with
   scripts/stress_500.py's options (windowed match graph over about 17
   thousand pairs, sweep, the loop-closing stage, global BA and three
   map-refinement rounds); one ``"phase": "loop"`` JSON line with each
   stage's seconds, the ATE after the sweep, after the loop stage and at
   the end, the stage statistics, the landmark slots allocated against the
   capacity and the ``digest``; gate: at least 950 of 1000 frames
   registered, ATE < 3.0, one ``match_pairs`` launch, the loop stage
   entered, three refinement rounds. Then both loop solvers on the card's
   own measurements of the finished scene under a smooth drift ramp (the
   gates must keep no less consistent a trajectory), five frames spread
   over the registered ones anchored to their ground truth in the
   reconstruction's frame (``anchors_in_estimate_frame``) and
   ``resume_sfm(abs_anchors=...)``: one ``"phase": "anchors"`` JSON line
   (both runs' stages, BAs and ATEs, each anchored frame's distance from
   its anchor, the anchored scene's ``digest``) and the reference script's
   verdict line; gate: at least 950 registered, anchored ATE < 0.1 and
   under the unanchored one, no ``match_pairs`` launch in the resume. Last
   the batched matcher at this shape against its plain version
   (``kernels[0].anchors``);
8. drives the seventh slice's paths (``stereo`` right after the streaming
   kernel check, so that its profiler session runs early in the process;
   the others after the anchors phase), each printing one JSON line with a
   ``"phase"`` key, its stage seconds, its ``match_pairs`` launches, the
   ``digest`` of its reconstruction where it ends in one, and the card:
   - ``parallel``: a process group of one rank over NCCL (``file://``
     store under ``chiprun_out/parallel``): ``match_all_pairs_sharded`` at
     the bench's P=5120 and ``refine_ba_sharded`` (and ``_ba`` on the mesh)
     on the first ``run_sfm`` scene's global problem, equal bits to the
     unsharded calls and to a second ``refine_ba`` required with no
     deterministic mode on, and ``sync_ranks`` (the scene, ``excluded``
     and flags broadcast from rank 0) returning rank 0's own state; two
     ranks on one card cannot share NCCL;
   - ``stereo`` (scripts/rgbd_recipe.py): the bench's frames as left views,
     right views 0.1 m along each camera's x axis, one
     ``features.match_pair`` a frame (kernel 1 at P=1, 100 launches), the
     row and disparity filter, ``stereo_depth_at_keypoints`` ->
     ``run_sfm_rgbd``: 101 ``match_pairs`` launches, at least 95 of 100
     registered, metric ATE (ground truth in frame 0's gauge, nothing
     fitted) under STEREO_MAX_ATE; ``match_pair`` against the same pair in
     a batched call (equal bits) and kernel 1 at P=1 against its plain
     version (``kernels[0].stereo``: a call, the card alone, the bound);
   - ``api``: ``detect_keypoints`` + ``describe_keypoints`` on frame 0 and
     ``ClassicalFrontend(512, batch=8)`` on the 100 frames, equal bits to
     ``extract_features``; ``device_trace`` around one ``match_pair`` call
     and ``memory_summary``;
   - ``rgbd``: the same world at TUM RGB-D's 640x480 with its nominal
     intrinsics and rendered 16-bit depth, written as a TUM directory under
     ``chiprun_out/rgbd`` -> ``TumDataset`` -> ``extract_features(K=1024)``
     -> ``depth_at_keypoints`` -> ``run_sfm_rgbd``: one ``match_pairs``
     launch, at least 95 of 100 registered, metric ATE under RGBD_MAX_ATE;
     run twice on the same directory, the second run equal to the first
     bit for bit as ``run_sfm``'s are; kernel 1 at N=100, Kp=1024, P=5120
     against its plain version (``kernels[0].rgbd``);
   - ``stress_100`` (the eleventh slice, after ``rgbd``):
     scripts/stress_100.py's 100 frames x 1024 tracks with 10% outlier
     descriptors (``stress_world``) and its options, ``run_sfm`` twice: at
     least 95 of 100 registered and ATE < 0.01 in each, one ``match_pairs``
     launch a run, the second run equal to the first bit for bit; kernel 1
     at N=100, Kp=1024, P=5120 against its plain version
     (``kernels[0].stress_100``);
   - ``examples`` (the twelfth slice, after ``api``): the port's three
     examples as subprocesses on the card, started together:
     ``extract_match_torch.py`` on frames 0 and 1 with either frontend
     (``--weights weights``: the shipped 3-layer matcher), the
     ``reconstruct_synthetic_torch.py`` demo and ``stream_reconstruct_torch.py``
     over 40 frames of a camera sliding past a smooth textured surface
     (``slide_frames``) in windows of 8 at 1024 keypoints, with
     ``SfmOptions``' defaults as in the JAX example; each must exit 0, the
     overlays exist, the demo's ATE be under 0.1 and the stream's
     transform.json hold at least 38 frames;
   - ``robustness`` (the twelfth slice, after ``stress_100``):
     scripts/robustness_matrix.py's classical column at full width on its
     three surface worlds (60 frames at 512x384, K=512, a local BA every
     3rd registration), the clean cell and the most severe blur,
     noise+blur and drop-frames cells (ROBUST_CELLS), the clean and
     noise+blur cells on RANSAC seeds 0-2 (ROBUST_SEEDS_OF), 24 runs and
     the clean cell's world 0 again (equal digests); gate per cell: every
     world at least 95% registered, the median ATE under 0.1 (under 1.5x
     the reference's 0.2265 at 2 px of blur; over several seeds, the median
     of the seeds' medians); kernel 1 at N=60, Kp=512, P=2048 against its
     plain version (``kernels[0].robustness``, with every cell's P);
   - ``recall`` (after ``robustness``): scripts/tune_deep_recall.py's
     held-out set (48 SuperPoint-output pairs, seed 99) through the shipped
     matcher at seven thresholds, 12 attention launches a forward, precision
     and recall within RECALL_TOL of the JAX package's CPU figures at each;
     one batch's scores with kernel 3 against the plain attention, and the
     kernel timed at ``[8, 4, 64, 64]`` (``kernels[1].recall``);
9. trains the deep frontend (``train``, the eighth slice), last, printing
   one JSON line with ``"phase": "train"``: ``train_lightglue`` at
   scripts/train_deep.py's recipe (3 layers, batch 8, 64 keypoints, lr
   3e-4) for 120 updates from ``init_params`` (gate: the mean loss of
   updates 30-39 below that of 10-19, both in the clean first third;
   exactly 12 attention launches an update); ``train_lightglue_sp`` at
   scripts/train_mix_driver.sh's recipe (the shipped SuperPoint and
   LightGlue, the mix of worlds, 256 keypoints at 224x168, batch 8, lr 2e-4,
   3 render workers) for 16 updates, with each update's seconds split into
   waiting for renders, extraction + labelling and the step, and its labels
   per pair (gate: finite losses, 12 launches an update), saved with
   ``save_params`` under ``chiprun_out/train`` and reloaded bit for bit
   through ``load_frontend_params``; ``train_superpoint`` from
   ``init_params`` and head-only from the shipped weights with them as the
   anchor (gate: backbone and descriptor head bit-identical, anchor term 0
   at step 0); ``weights/`` hashed before and after (equal). Then kernel 3
   in training: on step 2's batch the loss and every gradient with the
   kernel's forward pass (three runs) against the plain forward pass
   (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL), the card's step-0 loss against the
   CPU's, and the kernel timed at both training shapes, a call and on the
   card alone (``kernels[1].train``).

The phases write what they make under ``chiprun_out/`` (images, configs,
outputs, checkpoints). ``--dump`` / ``--dump-deep`` also save a path's match tables and
ground-truth poses, the input of ``scripts/init_pair_spread_{jax,torch}.py``
(``--dump-deep`` world 0's 6-tuple and the port's result, ``--dump-deep-world
W`` also world W's: the input of ``scripts/deep_sfm_replay_{jax,torch}.py``);
``--dump-loop`` the 1000-frame scene's poses and loop measurements, the input of
``scripts/loop_replay_{jax,torch}.py``.

Prints one JSON line of per-kernel numbers, then the contract line
``{"ok": true, "device": {...}}`` last. Any failure exits non-zero; without
a card, or without the port beside this script, it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the bench workload and options (bench.py)
N_FRAMES, WIDTH, HEIGHT, MAX_KPS = 100, 512, 384, 512
BENCH_OPTIONS = dict(
    min_initial_inliers=100, min_matches=25, match_ratio=0.85,
    init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=16384, refine_max_iters=30, global_max_iters=50,
    match_chunk=32, local_ba_every=4)
MAX_ROT_DEG, MAX_TRANS_DEG = 1.0, 5.0
# On the bench's first frames the best-ranked pair is nearly a pure
# rotation, and the reference's E-vs-H rule takes the homography path for
# about half of all RANSAC seeds; that path's translation direction is
# poorly conditioned. On the same match tables the JAX package's H path
# lands 8-15 deg off and the port's 8-17 deg (32 seeds each,
# scripts/init_pair_spread_{jax,torch}.py), so the H path is held to 20
# deg; its rotation, and the E path, keep the limits above.
MAX_TRANS_DEG_H = 20.0

# the deep path's workload and options (scripts/bench_deep.py)
DEEP_KPS, DEEP_WINDOW, DEEP_RETRIEVAL, DEEP_THRESHOLD = 1024, 10, 3, 0.15
DEEP_OPTIONS = dict(
    min_initial_inliers=60, min_matches=20, match_ratio=0.85,
    init_min_tri_angle_deg=1.0, min_tri_angle_deg=1.0,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=16384, refine_max_iters=30, global_max_iters=50,
    local_ba_every=3)
DEEP_VERIFY_SEED = 7
# The deep path's best-ranked pair (4, 12) has several two-view solutions of
# nearly equal support, and which one wins depends on the RANSAC draws: on
# the same match tables (--dump-deep), 16 seeds each on the CPU, the JAX
# package lands 0.21-0.64 deg / 1.5-7.0 deg off (rotation / translation
# direction) on 15 seeds and 1.87 / 29.75 deg on one; the port 0.26-1.56 deg
# / 1.5-18.6 deg (scripts/init_pair_spread_{jax,torch}.py
# --min-initial-inliers 60). Neither keeps every seed within the classical
# limits above, so the deep path is held to the reference's spread.
DEEP_MAX_ROT_DEG, DEEP_MAX_TRANS_DEG = 2.0, 30.0

# the streaming phase: the bench's frames arriving in windows of 10, through
# StreamingReconstructor(max_frames=100, K=512) with the bench's options
# (scripts/stream_reference_jax.py runs the same stream on the JAX package)
STREAM = dict(window=6, retrieval_k=2, finalize_every=5)
STREAM_CHUNK, STREAM_CHECKPOINT_AFTER = 10, 5

# H100 SXM dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
L2_BYTES = 50 * 1024 * 1024
REPEATS = 3     # each kernel-vs-plain comparison is run this often; results must be equal
PEAK_BYTES = 3.35e12


def require(ok, what) -> None:
    """Fail the run (an ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def render_workload():
    """The bench's 100-frame orbit through a blob field, with GT poses."""
    from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses, render_view

    rng = np.random.default_rng(0)
    f = 1.2 * max(WIDTH, HEIGHT)
    intr = np.array([f, f, WIDTH / 2, HEIGHT / 2], np.float32)
    scene = make_blob_scene(rng, n_blobs=900, depth=(3.5, 9.0), spread=2.6)
    poses = orbit_poses(N_FRAMES, radius=0.6, step_deg=0.5, advance=0.03)
    images = np.stack([render_view(scene, T, intr, WIDTH, HEIGHT) for T in poses])
    return images, poses, intr


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, dev) -> float:
    """Device milliseconds of one ``fn()`` right after the L2 was overwritten
    (a buffer of several times its size is filled first), so that ``fn``
    finds its inputs in device memory, as a path's only launch does."""
    import torch

    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device=dev)
    flush.fill_(1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` with the host out of the way:
    ``reps`` calls are enqueued while the card is still busy with a long
    matrix product, so the card runs them back to back."""
    import torch

    fn()
    big = torch.randn((8192, 8192), device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(4):
        big @ big
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The first kernel records of a profiler session can be lost: late in this
# long process, a session around one call of the single-pair wrapper (one
# launch) recorded no device event in 7 of 9 runs on the card, and sessions
# of twenty calls recorded 17-19 (PR 7). Each session therefore starts with
# a few fill kernels, synchronized, which take those places and are not
# counted.
PRIMER = "FillFunctor"


def profiler_primer() -> None:
    import torch

    for _ in range(4):
        torch.ones(1024, device="cuda")
    torch.cuda.synchronize()


def kernel_launches(fn) -> int:
    """Kernels that one ``fn()`` runs on the card, counted under
    ``torch.profiler`` (copies and memsets are not kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_primer()
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and PRIMER not in e.name]
    if not names:
        print(f"profiler: no device event of the call among {len(prof.events())} events: "
              f"{sorted({e.name[:50] for e in prof.events()})}", flush=True)
    require(names, "the profiler recorded no device activity")
    return sum(1 for n in names if not n.lower().startswith(("memcpy", "memset")))


def profiled_device_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device milliseconds per call of the kernels named ``name`` that
    ``fn()`` launches, from ``torch.profiler``'s device timeline: the card's
    time alone, without the host work of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiler_primer()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    if len(us) != reps:
        kinds = sorted({e.name[:60] for e in prof.events() if e.device_type == DeviceType.CUDA})
        print(f"profiler: {len(us)} {name} kernels in {reps} calls; device events {kinds}",
              flush=True)
    require(len(us) == reps, f"the profiler saw {len(us)} {name} kernels in {reps} calls")
    return sum(us) / reps / 1e3


def tidy(out: Path) -> None:
    """Remove a passed phase's bulky inputs and checkpoints (frames,
    ``.npz``), so that what the run leaves under chiprun_out/ stays small;
    configs, transform files and PLYs stay."""
    import shutil

    shutil.rmtree(out / "images", ignore_errors=True)
    for f in out.glob("*.npz"):
        f.unlink()


def repeated(fn, what):
    """``fn()`` REPEATS times, synchronized; every run must return the same
    bits as the first (a race shows as a result that changes). Returns the
    first result."""
    import torch

    first = None
    for i in range(REPEATS):
        out = fn()
        torch.cuda.synchronize()
        out = out if isinstance(out, tuple) else (out,)
        if first is None:
            first = out
        require(all(torch.equal(a, b) for a, b in zip(first, out)),
                f"{what}: run {i} differs from run 0")
    return first if len(first) > 1 else first[0]


def scene_digest(scene) -> str:
    """sha256 of a scene's pose and point bytes: equal digests, equal
    reconstructions (printed by every phase that ends in a scene, so that
    two calls can be compared)."""
    h = hashlib.sha256()
    for t in (scene.pose, scene.points):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def same_reconstruction(a, b) -> list[str]:
    """What differs between two runs' ``(scene, stats)`` on one input: the
    names of the scene fields (poses, points, masks, links) and statistics
    (registered, landmarks, the global BA's iterations and final cost)
    that are not equal bit for bit; empty when the runs are one."""
    import torch

    (sa, ta), (sb, tb) = a, b
    diff = [f for f in ("pose", "points", "pose_valid", "lm_valid", "kp2lm")
            if not torch.equal(getattr(sa, f), getattr(sb, f))]
    diff += [k for k in ("registered", "landmarks") if ta[k] != tb[k]]
    ba_a, ba_b = ta["global_ba"] or {}, tb["global_ba"] or {}
    diff += [f"global_ba.{k}" for k in ("iterations", "final_cost") if ba_a.get(k) != ba_b.get(k)]
    return diff


def run_slice(images, intr, dev, card):
    """images -> features -> seeded two-view map, timed per stage."""
    import torch
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.ops import reset_launch_counts, launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, initialize_sfm

    imgs = torch.as_tensor(images, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xy, desc, score, mask = extract_features(imgs, max_keypoints=MAX_KPS, device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    scene, stats = initialize_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                                  options=SfmOptions(**BENCH_OPTIONS), device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = launch_counts()
    secs = dict(extract=t_extract, **stats["seconds"], total=total)
    print(f"slice stages (s) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()), flush=True)
    return xy, desc, mask, scene, stats, launches


def check_features(xy, desc, mask, n_kps):
    """Shapes, finite values, keypoints in every frame; returns the count
    of keypoints per frame."""
    require(xy.shape == (N_FRAMES, n_kps, 2) and desc.shape == (N_FRAMES, n_kps, 256),
            (xy.shape, desc.shape))
    require(bool(xy.isfinite().all()) and bool(desc.isfinite().all()), "non-finite features")
    per_frame = mask.sum(1)
    require(int(per_frame.min()) > 0, "a frame has no keypoints")
    return per_frame


def check_seeded_map(tag, scene, stats, poses, max_rot=MAX_ROT_DEG, max_trans=None):
    """The init pair's pose against ground truth and the seeded landmarks."""
    rot, trans, max_rot, max_trans = init_pose_line(tag, stats, poses, max_rot, max_trans)
    require(rot < max_rot and trans < max_trans, f"init pose error {rot}, {trans} deg")
    pts = scene.points[scene.lm_valid]
    require(pts.shape[0] == stats["n_good"] and bool(pts.isfinite().all()),
            "seeded landmarks do not match n_good or are not finite")


def check_slice(xy, desc, mask, scene, stats, launches, poses):
    n_kps = check_features(xy, desc, mask, MAX_KPS)
    require(launches["match_pairs"] >= 1, f"the matcher never launched: {launches}")
    require(stats["pairs"] == 5120 and stats["edges"] > 0, stats)
    require(stats["initialized"] and stats["n_good"] > 100, stats)
    print(f"slice: keypoints/frame {int(n_kps.min())}-{int(n_kps.max())}", flush=True)
    check_seeded_map("slice", scene, stats, poses)


def run_full(images, intr, poses, dev, card, run, first=None):
    """images -> features -> finished reconstruction through
    ``extract_features`` and ``run_sfm`` at the bench's size and options,
    timed per stage; prints the run's JSON line and holds it to the
    bench's gate. ``first``: an earlier run's ``(scene, stats)`` on the
    same images, which this one must repeat bit for bit."""
    import torch
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.ops import reset_launch_counts, launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    imgs = torch.as_tensor(images, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xy, desc, _, mask = extract_features(imgs, max_keypoints=MAX_KPS, device=dev)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    scene, stats = run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                           options=SfmOptions(**BENCH_OPTIONS), device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = launch_counts()
    require(stats["initialized"], f"run_sfm found no init pair: {stats}")
    valid = scene.pose_valid.cpu().numpy()
    ate = trajectory_ate(scene.pose.cpu().numpy()[valid], poses[valid])   # bench.py's measure
    ba = stats["global_ba"]
    differ = [] if first is None else same_reconstruction(first, (scene, stats))
    print(json.dumps({
        "phase": "run_sfm", "run": run, "card": card,
        "seconds": dict(extract=t_extract, **stats["seconds"], total=total),
        "frames_per_s": N_FRAMES / total,
        "registered": stats["registered"], "excluded": stats["excluded"],
        "landmarks": stats["landmarks"], "ate": ate,
        "init_pair": list(stats["init_pair"]), "used_homography": stats["used_homography"],
        "n_good": stats["n_good"], "edges": stats["edges"], "global_ba": ba,
        "match_pairs_launches": launches["match_pairs"], "digest": scene_digest(scene),
        **({} if first is None else {"repeat_equal": not differ})}), flush=True)
    init_pose_line(f"run_sfm run {run}", stats, poses)
    require(not differ, f"run_sfm run {run} differs from run 0 on the same images in {differ}")
    require(launches["match_pairs"] == 1,
            f"run_sfm launched the matcher {launches['match_pairs']} times, not once")
    require(scene.pose.isfinite().all() and scene.points[scene.lm_valid].isfinite().all(),
            "run_sfm left non-finite poses or landmarks")
    require(ba is not None and ba["final_cost"] < ba["initial_cost"],
            f"the global BA did not run or did not reduce its cost: {ba}")
    require(stats["registered"] >= N_FRAMES - 5,
            f"bench gate: {stats['registered']} of {N_FRAMES} frames registered")
    require(ate < 0.1, f"bench gate: ATE {ate}")
    return scene, stats


def check_match_kernel(desc, mask, launches, card):
    """Kernel vs plain version on the main path's inputs; returns the
    kernel's JSON record."""
    import torch
    from eacham_tpu_torch.ops import match_kernel as mk
    from eacham_tpu_torch.sfm.matches import all_pairs_index, bucket_pairs

    dev = desc.device
    pairs = torch.as_tensor(bucket_pairs(all_pairs_index(desc.shape[0])), device=dev)
    desc_bf, m = mk.prepare(desc, mask)
    P, Kp = pairs.shape[0], desc_bf.shape[1]
    raw_k = repeated(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), "match kernel")
    raw_p = mk.match_pairs_plain(desc_bf, m, pairs)
    names = ("row best", "row argmax", "row second", "col best", "col argmax", "col second")
    equal = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, raw_k, raw_p)}
    max_err = max(float((raw_k[i] - raw_p[i]).abs().max()) for i in (0, 2, 3, 5))
    _, vk = mk.decide(raw_k, m, pairs, BENCH_OPTIONS["match_ratio"])
    _, vp = mk.decide(raw_p, m, pairs, BENCH_OPTIONS["match_ratio"])
    agree = float((vk == vp).float().mean())
    both = vk & vp
    same_j = bool(torch.equal(raw_k[1][both], raw_p[1][both]))
    print(f"match kernel vs plain (N={desc.shape[0]}, Kp={Kp}, P={P}), {REPEATS} equal runs: "
          f"raw equal {equal}, "
          f"max |best/second diff| {max_err:.3g}, decision agreement {agree:.6f}, "
          f"valid matches {int(vk.sum())} kernel / {int(vp.sum())} plain", flush=True)
    require(all(equal.values()) or (agree >= 0.999 and same_j),
            f"kernel disagrees with its plain version: {equal}, {agree}, {same_j}")

    # all keypoints masked: every output dead, no match
    dead = torch.zeros_like(m)
    few = pairs[:64].contiguous()
    raw_d = repeated(lambda: mk.match_pairs_kernel(desc_bf, dead, few), "match kernel, all masked")
    _, vd = mk.decide(raw_d, dead, pairs[:64], 0.8)
    require(not bool(vd.any()) and bool((raw_d[0] == mk.NEG).all())
            and bool((raw_d[3] == mk.NEG).all()), "all-masked case produced matches")
    print("match kernel all-masked case: no matches, all outputs dead", flush=True)

    # the path launches the kernel once, on descriptors that the frontend wrote
    # long before: the cold time is the one it pays, the warm mean the kernel's own
    cold = cold_ms(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), dev)
    ms = cuda_ms(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), reps=10)
    plain_ms = cuda_ms(lambda: mk.match_pairs_plain(desc_bf, m, pairs), reps=2)
    flops = 2.0 * P * Kp * Kp * desc_bf.shape[2]
    nbytes = (desc_bf.numel() * 2 + m.numel() + pairs.numel() * 4
              + sum(o.numel() * o.element_size() for o in raw_k))
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    # bucket_pairs pads with (0, 0) rows, which the kernel computes all the
    # same: the bound of the real pairs' products alone, beside it
    real = int((pairs[:, 0] < pairs[:, 1]).sum())
    real_bound_ms = max(flops * real / P / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    require(ms >= bound_ms, f"match kernel {ms} ms is under its bound {bound_ms} ms")
    # partial yardstick, never called by the port: the same bf16 products
    # as one batched matmul, without the masking and top-2 reductions
    a = desc_bf[pairs[:, 0].long()]
    b = desc_bf[pairs[:, 1].long()].transpose(1, 2)
    bmm_ms = cuda_ms(lambda: torch.bmm(a, b), reps=10)
    del a, b
    print(f"match kernel on {card}: {ms:.4f} ms warm (mean of 10), cold_ms {cold:.4f} (first "
          f"launch after the L2 was overwritten), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops:.4g} FLOP, {nbytes:.4g} B); partial yardstick torch.bmm of "
          f"the bf16 products alone {bmm_ms:.4f} ms", flush=True)
    return {"name": "match_pairs", "route": "cuda",
            "source": "eacham_tpu_torch/csrc/match_pairs.cu",
            "replaces": "eacham_tpu/ops/match_kernel.py:109",
            "launches": launches["match_pairs"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "cold_ms": cold}


def deep_front(models, imgs, intr, dev, kps=DEEP_KPS, window=DEEP_WINDOW,
               threshold=DEEP_THRESHOLD):
    """The deep path's front half, through the port's entry points, timed
    per stage: images -> SuperPoint features -> LightGlue match tables over
    windowed and retrieval candidate pairs, epipolar-verified
    (scripts/bench_deep.py's recipe; ``kps``, ``window`` and ``threshold``
    are its arguments). Returns (xy, desc, mask, tables, t_extract,
    t_match)."""
    import torch
    from eacham_tpu_torch.features.deep.frontend import (
        build_match_tables_deep, extract_deep_batch)
    from eacham_tpu_torch.sfm.pipeline import SfmOptions

    superpoint, matcher = models
    opt = SfmOptions(**DEEP_OPTIONS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xy, desc, _, mask = extract_deep_batch(superpoint, imgs, max_keypoints=kps, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables = build_match_tables_deep(
        matcher, xy, desc, mask, (WIDTH, HEIGHT), min_matches=opt.min_matches,
        pair_window=window, retrieval_k=DEEP_RETRIEVAL, threshold=threshold,
        verify=(intr, torch.Generator(device=dev).manual_seed(DEEP_VERIFY_SEED),
                opt.max_repr_error, opt.verify_hyps), device=dev)
    torch.cuda.synchronize()
    return xy, desc, mask, tables, t1 - t0, time.perf_counter() - t1


def deep_stages(models, imgs, intr, dev):
    """The deep path's front half (``deep_front``), then the seeded
    two-view map. Returns (xy, desc, mask, tables, scene, stats, seconds)."""
    import torch
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, initialize_sfm

    t0 = time.perf_counter()
    xy, desc, mask, tables, t_extract, t_match = deep_front(models, imgs, intr, dev)
    scene, stats = initialize_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                                  options=SfmOptions(**DEEP_OPTIONS), device=dev,
                                  match_tables=tables)
    torch.cuda.synchronize()
    secs = dict(extract_deep=t_extract, match_deep=t_match,
                init_pair=stats["seconds"]["init_pair"],
                seed=stats["seconds"].get("seed", 0.0), total=time.perf_counter() - t0)
    return xy, desc, mask, tables, scene, stats, secs


def run_deep(images, intr, dev, card):
    """The deep path at full size with the shipped weights; launch counts
    set to 0 just before and read just after."""
    import torch
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts

    superpoint, matcher, n_layers = load_frontend_params(device=dev)
    for model, fname, name, key in (
            (superpoint, "superpoint.npz", "det2.bias", "['params']/['det2']/['bias']"),
            (matcher, "lightglue.npz", "final1.bias", "['params']/['final1']/['bias']")):
        shipped = ROOT / "weights" / fname
        require(model.weights_path == str(shipped), f"{fname}: loaded from {model.weights_path}")
        with np.load(shipped) as data:
            want = torch.as_tensor(np.array(data[key], dtype=np.float32), device=dev)
        require(torch.equal(model.get_parameter(name), want), f"{fname}: {name} differs")
    print(f"deep frontend: shipped weights loaded from {ROOT.name}/weights "
          f"(SuperPoint 256-d, LightGlue {n_layers} layers x 4 attention blocks)", flush=True)

    imgs = torch.as_tensor(images, device=dev)
    reset_launch_counts()
    out = deep_stages((superpoint, matcher), imgs, intr, dev)
    launches = launch_counts()
    print(f"deep path stages (s) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out[-1].items()), flush=True)
    return (superpoint, matcher), out, launches


def init_pose_line(tag, stats, poses, max_rot=MAX_ROT_DEG, max_trans=None):
    """Print the init pair's pose error against its limits (by default the
    classical slice's); returns (rot, trans, max_rot, max_trans)."""
    from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg

    i0, j0 = stats["init_pair"]
    T = stats["T_init"].cpu().numpy()
    require(np.isfinite(T).all(), "non-finite init pose")
    rot, trans = relative_pose_error_deg(T, poses[i0], poses[j0])
    if max_trans is None:
        max_trans = MAX_TRANS_DEG_H if stats["used_homography"] else MAX_TRANS_DEG
    print(f"{tag}: edges {stats['edges']}/{stats['pairs']}, init pair ({i0}, {j0}), "
          f"n_good {stats['n_good']}, homography {stats['used_homography']}, "
          f"pose error rot {rot:.4f} deg (limit {max_rot}), "
          f"t-dir {trans:.4f} deg (limit {max_trans})", flush=True)
    return rot, trans, max_rot, max_trans


def check_deep(models, out, launches, poses):
    from eacham_tpu_torch.features.deep.frontend import PAIR_CHUNK
    from eacham_tpu_torch.sfm.matches import bucket_pairs, candidate_pairs

    xy, desc, mask, tables, scene, stats, secs = out
    n_kps = check_features(xy, desc, mask, DEEP_KPS)
    cand = candidate_pairs(desc, mask, window=DEEP_WINDOW, retrieval_k=DEEP_RETRIEVAL)
    P = bucket_pairs(cand).shape[0]
    require(tables[0].shape[0] == P and stats["pairs"] == P, (tables[0].shape, stats["pairs"], P))
    want = -(-P // PAIR_CHUNK) * 4 * models[1].n_layers
    print(f"deep path: keypoints/frame {int(n_kps.min())}-{int(n_kps.max())}, candidate pairs "
          f"{len(cand)} bucketed to {P}, chunk {PAIR_CHUNK}, kernel launches {launches} "
          f"(attention expected {want})", flush=True)
    require(launches["masked_attention"] == want, f"attention launches {launches}, want {want}")
    require(stats["edges"] > 0, stats)
    require(stats["initialized"] and stats["n_good"] >= DEEP_OPTIONS["min_initial_inliers"], stats)
    check_seeded_map("deep path", scene, stats, poses, DEEP_MAX_ROT_DEG, DEEP_MAX_TRANS_DEG)
    require(secs["total"] < 120.0, f"the deep path took {secs['total']:.1f} s")


def attention_vs_plain(matcher, xy, desc, mask, tables, tag):
    """Kernel 3 against its plain version on the first chunk of pairs of a
    deep match graph, as the matcher makes its inputs (the first self and
    the first cross block), three runs with equal bits required. Returns
    ({block: max abs err}, {block: (q, k, v, mask)})."""
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep.frontend import PAIR_CHUNK
    from eacham_tpu_torch.ops import attention as at

    # replay the first chunk of pairs with the matcher's attention call recorded
    seen = []
    inner = lg.attention

    def record(q, k, v, m):
        seen.append((q, k, v, m))
        return inner(q, k, v, m)

    pi = tables[0][:PAIR_CHUNK].long()
    kps = lg.normalize_keypoints(xy, float(WIDTH), float(HEIGHT))
    lg.attention = record
    try:
        lg.match_deep(matcher, kps[pi[:, 0]], desc[pi[:, 0]], mask[pi[:, 0]],
                      kps[pi[:, 1]], desc[pi[:, 1]], mask[pi[:, 1]], threshold=DEEP_THRESHOLD)
    finally:
        lg.attention = inner
    require(len(seen) == 4 * matcher.n_layers, f"{len(seen)} attention calls in one chunk")
    cases = {"self": seen[0], "cross": seen[2]}
    errs = {}
    for name, (q, k, v, m) in cases.items():
        require(tuple(q.shape) == (PAIR_CHUNK, 4, DEEP_KPS, 64), q.shape)
        o = repeated(lambda: at.masked_attention_kernel(q, k, v, m), f"attention, {name} block")
        ref = at.masked_attention_plain(q, k, v, m)
        scale = max(1.0, float(v.abs().max()))
        errs[name] = float((o - ref).abs().max())
        print(f"attention kernel vs plain, {tag} {name} block {tuple(q.shape)}, "
              f"{REPEATS} equal runs: "
              f"max abs err {errs[name]:.3g} (limit 1e-5 x max(1, |v|max = {scale:.3g})), "
              f"live keys {int(m.sum())}/{m.numel()}", flush=True)
        require(errs[name] < 1e-5 * scale, f"attention kernel off by {errs[name]} ({name})")
    return errs, cases


def check_attention_kernel(models, out, launches, card):
    """Kernel vs plain version on one chunk's q, k, v and mask as the main
    path makes them (first self and first cross block), plus the ragged
    and the fully masked cases; returns the kernel's JSON record."""
    import torch
    import torch.nn.functional as F
    from eacham_tpu_torch.ops import attention as at

    dev = out[1].device
    errs, cases = attention_vs_plain(models[1], *out[:4], "main-path")

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 4, 130, 64), generator=g, device=dev)
    k = torch.randn((2, 4, 70, 64), generator=g, device=dev)
    v = torch.randn((2, 4, 70, 64), generator=g, device=dev)
    m = torch.rand((2, 70), generator=g, device=dev) > 0.5
    m[0] = False                                   # batch entry 0: no live key
    o = repeated(lambda: at.masked_attention_kernel(q, k, v, m), "attention, ragged")
    err_small = float((o - at.masked_attention_plain(q, k, v, m)).abs().max())
    ragged_ms = cuda_ms(lambda: at.masked_attention_kernel(q, k, v, m), reps=20)
    print(f"attention kernel vs plain, Nq 130 / Nk 70 with a fully masked batch entry, "
          f"{REPEATS} equal runs: "
          f"max abs err {err_small:.3g} (limit 1e-5), fully masked rows max "
          f"{float(o[0].abs().max()):.3g} (exact zeros required)", flush=True)
    require(err_small < 1e-5 and float(o[0].abs().max()) == 0.0 and bool(o.isfinite().all()),
            "attention kernel fails the ragged / fully masked case")

    cq, ck, cv, cm = cases["cross"]
    cross_ms = cuda_ms(lambda: at.masked_attention_kernel(cq, ck, cv, cm), reps=10)
    print(f"attention kernel on {card}: {cross_ms:.4f} ms at the cross block and its mask "
          f"({int(cm.sum())}/{cm.numel()} keys live), {ragged_ms:.4f} ms at the ragged "
          f"[2, 4, 130, 64] / Nk 70", flush=True)
    q, k, v, m = cases["self"]
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    ms = cuda_ms(lambda: at.masked_attention_kernel(q, k, v, m), reps=10)
    plain_ms = cuda_ms(lambda: at.masked_attention_plain(q, k, v, m), reps=3)
    # yardstick only, never called by the port
    bias = m[:, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias), reps=10)
    # masked keys need no work: count the live ones (all keys when none is masked)
    flops = 4.0 * H * Nq * D * float(m.sum())
    nbytes = 4.0 * (q.numel() + k.numel() + v.numel() + q.numel()) + m.numel()
    # the least time for this function at fp32 accuracy: fp32 FMAs on the CUDA
    # cores, or three TF32 tensor-core products for each fp32 product (the
    # kernel's route), whichever is faster
    t_fma, t_3x = flops / PEAK_FP32_FLOPS, 3.0 * flops / PEAK_TF32_FLOPS
    t_ops, t_bytes = min(t_fma, t_3x), nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = ("operations (3xTF32)" if t_3x < t_fma else "operations") \
        if t_ops >= t_bytes else "bytes"
    print(f"attention kernel on {card}, [B={B}, H={H}, Nq={Nq}, Nk={Nk}, D={D}]: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: 3 x {flops:.4g} FLOP over the TF32 peak "
          f"{PEAK_TF32_FLOPS:.3g}/s; over the fp32 peak {PEAK_FP32_FLOPS:.3g}/s it is "
          f"{t_fma * 1e3:.4f} ms; {nbytes:.4g} B over {PEAK_BYTES:.3g} B/s)", flush=True)
    require(ms >= bound_ms, f"attention kernel {ms} ms is under its bound {bound_ms} ms")
    return {"name": "masked_attention", "route": "cuda",
            "source": "eacham_tpu_torch/csrc/masked_attention.cu",
            "replaces": "eacham_tpu/ops/attention.py:32",
            "launches": launches["masked_attention"], "max_abs_err": max(errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_e2e(models, images, dev, card):
    """``match_images_e2e`` on world 0's frames 0 and 1 (the launch counts
    set to 0 just before and read just after): exactly 4 * n_layers
    attention launches, and the same matches as ``match_all_pairs_deep`` on
    that pair from the same two frames' features, one pair a pass (the
    shapes ``match_images_e2e`` gives the matcher, so the bits can agree)."""
    import torch
    from eacham_tpu_torch.features.deep.frontend import (
        extract_deep_batch, match_all_pairs_deep, match_images_e2e)
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts

    superpoint, matcher = models
    imgs = torch.as_tensor(images[:2], device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    uv0, uv1, valid, mscore = match_images_e2e(superpoint, matcher, imgs, max_keypoints=DEEP_KPS,
                                               threshold=DEEP_THRESHOLD, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    xy, desc, _, mask = extract_deep_batch(superpoint, imgs, max_keypoints=DEEP_KPS, device=dev)
    mj, mv, _ = match_all_pairs_deep(matcher, xy, desc, mask,
                                     torch.tensor([[0, 1]], device=dev), (WIDTH, HEIGHT),
                                     chunk=1, threshold=DEEP_THRESHOLD)
    want = 4 * matcher.n_layers
    same = (torch.equal(valid, mv[0]) and torch.equal(uv0, xy[0])
            and torch.equal(uv1[valid], xy[1][mj[0].long()][valid]))
    print(f"match_images_e2e on frames 0 and 1 on {card}: {int(valid.sum())} matches (mean "
          f"score {float(mscore[valid].mean()):.4f}), {secs:.4f} s, launches {launches} "
          f"(attention expected {want}), the same matches as match_all_pairs_deep: {same}",
          flush=True)
    require(launches["masked_attention"] == want and launches["match_pairs"] == 0,
            f"match_images_e2e launches {launches}, want {want} of masked_attention")
    require(int(valid.sum()) > 0 and same,
            "match_images_e2e differs from match_all_pairs_deep on frames 0 and 1")


def run_pair_path(desc, mask):
    """The single-pair entry point on frames 0 and 1 of the deep features;
    launch counts set to 0 just before and read just after."""
    import torch
    from eacham_tpu_torch import ops

    ops.reset_launch_counts()
    match_j, valid = ops.match_pair_fused(desc[0], desc[1], mask[0], mask[1],
                                          ratio=DEEP_OPTIONS["match_ratio"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    require(match_j.shape == (DEEP_KPS,) and valid.shape == (DEEP_KPS,), match_j.shape)
    require(int(valid.sum()) > 0, "match_pair_fused found no match between frames 0 and 1")
    print(f"single-pair path: match_pair_fused(frame 0, frame 1) -> {int(valid.sum())} matches "
          f"of {int(mask[0].sum())} keypoints, kernel launches {launches}", flush=True)
    return launches


def check_match_pair_kernel(desc, mask, launches, card):
    """Single-pair kernel vs plain version on the deep features of frames 0
    and 1 (K1 = K2 = 1024) and on a ragged K1 200 / K2 170 cut of them;
    returns the kernel's JSON record."""
    import torch
    from eacham_tpu_torch.ops import match_kernel as mk

    ratio = DEEP_OPTIONS["match_ratio"]
    max_err = 0.0
    for K1, K2 in ((DEEP_KPS, DEEP_KPS), (200, 170)):
        d1, d2 = desc[0, :K1].contiguous(), desc[1, :K2].contiguous()
        m1, m2 = mask[0, :K1].contiguous(), mask[1, :K2].contiguous()
        raw_k = mk.match_pair_kernel(d1, d2, m1, m2)
        torch.cuda.synchronize()
        raw_p = mk.match_pair_plain(d1, d2, m1, m2)
        equal = [bool(torch.equal(a, b)) for a, b in zip(raw_k, raw_p)]
        err = max(float((raw_k[i] - raw_p[i]).abs().max()) for i in (0, 2, 3, 5))
        max_err = max(max_err, err)
        ak, vk = mk.match_pair_fused(d1, d2, m1, m2, ratio)
        ap, vp = mk.match_pair_fused(d1.cpu(), d2.cpu(), m1.cpu(), m2.cpu(), ratio)
        vk, ak = vk.cpu(), ak.cpu()
        agree = float((vk == vp).float().mean())
        same_j = bool(torch.equal(ak[vk & vp], ap[vk & vp]))
        print(f"match_pair kernel vs plain (K1={K1}, K2={K2}): raw outputs equal {equal}, "
              f"max |best/second diff| {err:.3g} (one quantization step is 6.1e-5: fp32 "
              f"summation order may flip a step), decisions agree {agree:.6f}, "
              f"valid {int(vk.sum())} kernel / {int(vp.sum())} plain", flush=True)
        require(all(equal) or (agree >= 0.999 and same_j and err <= 2.0 / 16384),
                f"match_pair kernel disagrees with its plain version: {equal}, {agree}")

    # exact inputs (entries are multiples of 1/16, so every product sum is
    # exact in any order): the raw outputs must be equal bit for bit, in
    # every one of REPEATS runs, whatever block merges last
    g = torch.Generator(device=desc.device).manual_seed(5)
    for K1, K2, live in ((1024, 1024, "random"), (1000, 777, "random"),
                         (1024, 1024, "none"), (1000, 777, "none"),
                         (1024, 1024, "one"), (1000, 777, "one")):
        e1 = torch.randint(-1, 2, (K1, 256), generator=g, device=desc.device) / 16.0
        e2 = torch.randint(-1, 2, (K2, 256), generator=g, device=desc.device) / 16.0
        if live == "random":
            l1 = torch.rand(K1, generator=g, device=desc.device) > 0.2
            l2 = torch.rand(K2, generator=g, device=desc.device) > 0.2
        else:
            l1 = torch.zeros(K1, dtype=torch.bool, device=desc.device)
            l2 = torch.zeros(K2, dtype=torch.bool, device=desc.device)
            if live == "one":
                l1[K1 // 2], l2[K2 - 1] = True, True
        raw_k = repeated(lambda: mk.match_pair_kernel(e1, e2, l1, l2),
                         f"match_pair kernel, exact {K1} x {K2}, live {live}")
        raw_p = mk.match_pair_plain(e1, e2, l1, l2)
        equal = [bool(torch.equal(a, b)) for a, b in zip(raw_k, raw_p)]
        require(all(equal), f"match_pair kernel differs from its plain version on exact "
                            f"inputs ({K1} x {K2}, live {live}): {equal}")
        if live == "none":
            require(bool((raw_k[0] == mk.NEG).all()) and bool((raw_k[3] == mk.NEG).all()),
                    "all-dead case produced live outputs")
    print(f"match_pair kernel vs plain on exact inputs (1024 x 1024 and 1000 x 777; random, "
          f"no and one live keypoint): all raw outputs bit-equal in {REPEATS} runs each",
          flush=True)

    d1, d2 = desc[0].contiguous(), desc[1].contiguous()
    m1, m2 = mask[0].contiguous(), mask[1].contiguous()
    launches_per_call = kernel_launches(lambda: mk.match_pair_kernel(d1, d2, m1, m2))
    require(launches_per_call == 1,
            f"one call of match_pair_kernel launched {launches_per_call} kernels")
    before = mk.match_pair_kernel.launches
    ms = cuda_ms(lambda: mk.match_pair_kernel(d1, d2, m1, m2), reps=20)
    require(mk.match_pair_kernel.launches == before + 21,
            "match_pair_kernel does not count one launch per call")
    device_ms = queued_ms(lambda: mk.match_pair_kernel(d1, d2, m1, m2), reps=50)
    plain_ms = cuda_ms(lambda: mk.match_pair_plain(d1, d2, m1, m2), reps=5)
    K1, K2 = d1.shape[0], d2.shape[0]
    flops = 2.0 * K1 * K2 * d1.shape[1]
    nbytes = 4.0 * (d1.numel() + d2.numel()) + K1 + K2 + 12.0 * (K1 + K2)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"match_pair kernel on {card}, K1=K2={K1}: {ms:.4f} ms a call (mean of 20, the "
          f"wrapper's host work included), {device_ms:.4f} ms on the card alone (50 calls "
          f"queued behind a long product), {launches_per_call} kernel launch per call, "
          f"plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP over the fp32 peak "
          f"{PEAK_FP32_FLOPS:.3g}/s, {nbytes:.4g} B over {PEAK_BYTES:.3g} B/s)", flush=True)
    require(device_ms >= bound_ms, f"match_pair {device_ms} ms is under its bound {bound_ms}")
    return {"name": "match_pair", "route": "cuda",
            "source": "eacham_tpu_torch/csrc/match_pair.cu",
            "replaces": "eacham_tpu/ops/match_kernel.py:31",
            "launches": launches["match_pair"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "launches_per_call": launches_per_call,
            "device_ms": device_ms}


# ---- the fifth slice: command line, resume, streaming ---------------------------

OUT = ROOT / "chiprun_out"
# the CLI's configuration in the reference's schema, on the bench's frames and
# the bench's thresholds (the schema carries no RANSAC counts, local-BA
# cadence or landmark capacity: those stay at SfmOptions' defaults)
CLI_CONFIG = {
    "images_path": "/images", "transform_path": "/transform.json", "nerfy": True,
    "max_data_count": 0, "ui": False,
    "feature": {"min_features_count": 50, "max_features_count": 15000, "inliers_ratio": 0.85},
    "reconstruction": {
        "initial_pair": {"min_inliers": 100, "min_matches": 10, "min_corrs": 10,
                         "max_reprojection_error": 4.0, "min_angle": 1.0},
        "processing": {"min_matches": 10, "min_corrs": 10, "max_reprojection_error": 8.0,
                       "min_angle": 1.0, "min_pnp_inliers": 15}},
    "refine_ba": {"method": "LM", "max_iter": 30, "max_toler": 1e-5, "delta": 10.0,
                  "use_preconditioner": False},
    "global_ba": {"method": "LM", "max_iter": 50, "max_toler": 1e-7, "delta": 10.0,
                  "use_preconditioner": False},
}
# `--frontend deep` matches all pairs with LightGlue: 24 frames (276 pairs)
# keep the phase inside the time limit. Its thresholds are the deep bench's
# (scripts/bench_deep.py: 60 initial inliers, match threshold 0.15), its
# bounds are justified in PERF.md (Findings, PR 5).
DEEP_CLI_FRAMES, DEEP_CLI_THRESHOLD, DEEP_CLI_MIN_INLIERS = 24, 0.15, 60
DEEP_CLI_MIN_REGISTERED, DEEP_CLI_MAX_ATE = 22, 0.1
RESUME_FROM, RESUME_SEGMENT = 50, 16


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def write_pgm(path: Path, img: np.ndarray) -> None:
    """One 8-bit binary PGM (P5): the frame quantized as an 8-bit image
    file holds it (truncation, as tests/test_cli.py writes its PNGs)."""
    u8 = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    path.write_bytes(f"P5\n{u8.shape[1]} {u8.shape[0]}\n255\n".encode() + u8.tobytes())


def ply_count(path: Path) -> int:
    """Vertices of an ASCII PLY; fails unless its body holds exactly the
    header's count."""
    lines = path.read_text().splitlines()
    require(lines[0] == "ply" and lines[2].startswith("element vertex"), f"{path}: header")
    n = int(lines[2].split()[-1])
    body = len(lines) - lines.index("end_header") - 1
    require(body == n, f"{path}: header says {n} vertices, body has {body}")
    return n


def run_cli(images, poses, dev, card, deep_layers: int = 0):
    """Images on disk -> ``eacham_tpu_torch.cli.main`` in this process ->
    transform.json, transforms_nerf.json, cloud.ply, trajectory.ply; the
    launch counts and the stage timer set to 0 just before and read just
    after. ``deep_layers > 0``: ``--frontend deep`` with a LightGlue of that
    many layers. Returns the phase's record."""
    import shutil

    import torch
    from eacham_tpu_torch import cli
    from eacham_tpu_torch.io.images import load_image_dir
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.matches import all_pairs_index, bucket_pairs
    from eacham_tpu_torch.utils import timer
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    deep = deep_layers > 0
    out = OUT / ("cli_deep" if deep else "cli")
    shutil.rmtree(out, ignore_errors=True)
    (out / "images").mkdir(parents=True)
    n = len(images)
    for i, img in enumerate(images):
        write_pgm(out / "images" / f"frame{i:03d}.pgm", img)
    cfg = json.loads(json.dumps(CLI_CONFIG))
    cfg["root_path"] = str(out)
    argv = [str(out / "config.json"), "--max-keypoints", str(MAX_KPS), "--quiet",
            "--device", torch.device(dev).type]
    if deep:
        cfg["max_data_count"] = n
        cfg["reconstruction"]["initial_pair"]["min_inliers"] = DEEP_CLI_MIN_INLIERS
        argv += ["--frontend", "deep", "--match-threshold", str(DEEP_CLI_THRESHOLD)]
    (out / "config.json").write_text(json.dumps(cfg, indent=1))

    sync(dev)
    timer.reset_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    sync(dev)
    total = time.perf_counter() - t0
    launches = launch_counts()
    stages = {k: sum(v) / 1e3 for k, v in timer.stats().items()}
    decoder = load_image_dir(out / "images", max_count=cfg["max_data_count"]).backend

    data = json.loads((out / "transform.json").read_text())
    frames = data["frames"]
    ids = [int(f["file_path"][5:8]) for f in frames]
    est = np.stack([np.asarray(f["transform_matrix"]) for f in frames])
    ate = trajectory_ate(est, poses[ids]) if len(frames) >= 3 else float("inf")
    nerf = json.loads((out / "transforms_nerf.json").read_text())["frames"]
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    nerf_ok = len(nerf) == len(frames) and all(
        np.allclose(np.asarray(b["transform_matrix"]), np.linalg.inv(np.asarray(a["transform_matrix"])) @ flip,
                    atol=1e-9) for a, b in zip(frames, nerf))
    n_cloud = ply_count(out / "cloud.ply")
    n_traj = ply_count(out / "trajectory.ply")
    # (the scene stays inside the CLI: its poses and points as written)
    digest = hashlib.sha256((out / "transform.json").read_bytes()
                            + (out / "cloud.ply").read_bytes()).hexdigest()
    rec = {"phase": "cli_deep" if deep else "cli", "card": card, "frames": n,
           "max_data_count": cfg["max_data_count"], "exit_code": rc, "decoder": decoder,
           "seconds": {**stages, "total": total}, "registered": len(frames), "ate": ate,
           "cloud_points": n_cloud, "trajectory_points": n_traj, "digest": digest,
           "match_pairs_launches": launches["match_pairs"],
           "masked_attention_launches": launches["masked_attention"]}
    print(json.dumps(rec), flush=True)
    require(rc == 0, f"cli exited with {rc}")
    require(decoder in ("native", "pil", "native+pil"), f"decoder {decoder}")
    require(nerf_ok, "transforms_nerf.json is not inv(pose) @ diag(1, -1, -1, 1)")
    require(n_traj == len(frames) and n_cloud > 0, (n_traj, n_cloud))
    require(bool(torch.isfinite(torch.as_tensor(est)).all()), "non-finite poses in transform.json")
    if deep:
        from eacham_tpu_torch.features.deep.frontend import PAIR_CHUNK

        P = bucket_pairs(all_pairs_index(n)).shape[0]
        want = -(-P // PAIR_CHUNK) * 4 * deep_layers
        require(launches["masked_attention"] == want,
                f"attention launches {launches['masked_attention']}, want {want}")
        require(len(frames) >= DEEP_CLI_MIN_REGISTERED,
                f"cli_deep: {len(frames)} of {n} frames registered")
        require(ate < DEEP_CLI_MAX_ATE, f"cli_deep: ATE {ate}")
    else:
        require(launches["match_pairs"] == 1,
                f"the CLI launched the matcher {launches['match_pairs']} times, not once")
        require(len(frames) >= n - 5, f"cli gate: {len(frames)} of {n} frames in transform.json")
        require(ate < 0.1, f"cli gate: ATE {ate}")
    tidy(out)
    return rec


def deregistered(scene, first: int):
    """The scene with frames ``first``.. taken out of the map, as an
    interrupted run leaves it (tests/test_export_checkpoint.py's way)."""
    import torch

    drop = scene.pose_valid & (torch.arange(scene.pose_valid.shape[0],
                                            device=scene.pose_valid.device) >= first)
    return scene._replace(pose_valid=scene.pose_valid & ~drop,
                          kp2lm=torch.where(drop[:, None], -1, scene.kp2lm))


def run_resume(scene, poses, dev, card):
    """A finished scene with frames 50.. de-registered -> ``save_scene`` ->
    ``load_scene`` -> ``resume_sfm(finalize=False)`` writing checkpoints every
    segment of 16 -> the last checkpoint loaded and resumed with
    ``finalize=True``; the bench's gate on the result."""
    import torch
    from eacham_tpu_torch.io.checkpoint import load_scene, save_scene
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, resume_sfm
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    out = OUT / "resume"
    out.mkdir(parents=True, exist_ok=True)
    ck = out / "checkpoint.npz"
    ck.unlink(missing_ok=True)
    opt = SfmOptions(**BENCH_OPTIONS, max_features=MAX_KPS, sweep_segment=RESUME_SEGMENT,
                     checkpoint_path=str(ck))
    partial = deregistered(scene, RESUME_FROM)
    sync(dev)
    t0 = time.perf_counter()
    save_scene(out / "partial.npz", partial)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, _ = load_scene(out / "partial.npz", device=dev)
    sync(dev)
    t_load = time.perf_counter() - t0
    require(all(torch.equal(a, b) for a, b in zip(loaded, partial)),
            "load_scene(save_scene(scene)) differs from the scene")
    swept, st1 = resume_sfm(loaded, options=opt, verbose=False, finalize=False, device=dev)
    last, _ = load_scene(ck, device=dev)
    kept = bool((last.pose_valid <= swept.pose_valid).all())
    final, st2 = resume_sfm(last, options=dataclasses.replace(opt, checkpoint_path=None),
                            verbose=False, finalize=True, device=dev)
    valid = final.pose_valid.cpu().numpy()
    ate = trajectory_ate(final.pose.cpu().numpy()[valid], poses[valid])
    rec = {"phase": "resume", "card": card, "from_registered": int(partial.pose_valid.sum()),
           "seconds": {"save_scene": t_save, "load_scene": t_load,
                       "sweep": st1["seconds"]["sweep"], "resume_sweep": st2["seconds"]["sweep"],
                       "finalize": st2["seconds"]["finalize"]},
           "checkpoints": st1["checkpoints"], "swept_registered": st1["registered"],
           "checkpoint_registered": int(last.pose_valid.sum()),
           "registered": st2["registered"], "landmarks": st2["landmarks"], "ate": ate,
           "global_ba": st2["global_ba"], "digest": scene_digest(final)}
    print(json.dumps(rec), flush=True)
    require(st1["checkpoints"] >= 3, f"resume wrote {st1['checkpoints']} checkpoints")
    require(kept, "the last checkpoint registers a frame that the sweep did not")
    require(torch.equal(final.pose_valid, swept.pose_valid),
            "resuming from the last checkpoint registers other frames than the sweep")
    require(st2["registered"] >= N_FRAMES - 5, f"resume gate: {st2['registered']} registered")
    require(ate < 0.1, f"resume gate: ATE {ate}")
    tidy(out)
    return rec


def run_stream(images, poses, intr, dev, card):
    """The bench's frames through ``StreamingReconstructor`` in windows of
    10; after window 5 ``checkpoint`` and ``restore`` into a new object;
    ``finalize()`` at the end. Launch counts set to 0 before each window and
    read after it. Returns (record, window 5's matcher inputs)."""
    import torch
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions
    from eacham_tpu_torch.sfm.streaming import StreamingReconstructor
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    opt = SfmOptions(**BENCH_OPTIONS, max_features=MAX_KPS)
    size = (WIDTH, HEIGHT)
    rec = StreamingReconstructor(size, intr=intr, options=opt, max_frames=N_FRAMES,
                                 device=dev, **STREAM)
    imgs = torch.as_tensor(images, device=dev)
    windows, captured = [], None
    t_stream = time.perf_counter()
    for w, s in enumerate(range(0, N_FRAMES, STREAM_CHUNK), start=1):
        c0 = rec.pair_cursor
        sync(dev)
        reset_launch_counts()
        t = time.perf_counter()
        st = rec.process(imgs[s:s + STREAM_CHUNK])
        sync(dev)
        secs = time.perf_counter() - t
        launches = launch_counts()["match_pairs"]
        arrived_ok = not bool(rec.scene.pose_valid[rec.n_frames:].any())
        windows.append({"window": w, "seconds": secs, "arrived": st["arrived"],
                        "registered": st["registered"], "new_pairs": st["new_pairs"],
                        "finalized": "global_ba" in st,
                        "match_pairs_launches": launches})
        print(f"stream window {w}: {secs:.4f} s, arrived {st['arrived']}, registered "
              f"{st['registered']}, new pairs {st['new_pairs']}, match_pairs launches "
              f"{launches}", flush=True)
        require(arrived_ok, f"window {w}: an unarrived frame is registered")
        require(launches == 1, f"window {w}: {launches} matcher launches, not one")
        if w == STREAM_CHECKPOINT_AFTER:
            captured = (rec.desc.clone(), rec.scene.kp_mask.clone(),
                        rec.scene.pair_idx[c0:rec.pair_cursor].clone())
            path = OUT / "stream" / "stream.npz"
            path.parent.mkdir(parents=True, exist_ok=True)
            t = time.perf_counter()
            rec.checkpoint(path)
            t_ck = time.perf_counter() - t
            t = time.perf_counter()
            rec2 = StreamingReconstructor.restore(
                path, size, options=opt, window=STREAM["window"],
                retrieval_k=STREAM["retrieval_k"], finalize_every=STREAM["finalize_every"],
                device=dev)
            sync(dev)
            t_restore = time.perf_counter() - t
            require(rec2.n_frames == rec.n_frames and rec2.pair_cursor == rec.pair_cursor
                    and rec2.names == rec.names and torch.equal(rec2.desc, rec.desc)
                    and all(torch.equal(a, b) for a, b in zip(rec2.scene, rec.scene)),
                    "the restored stream differs from the checkpointed one")
            rec = rec2
    sync(dev)
    t = time.perf_counter()
    st = rec.finalize()
    sync(dev)
    t_final = time.perf_counter() - t
    total = time.perf_counter() - t_stream
    valid = rec.scene.pose_valid.cpu().numpy()
    ate = trajectory_ate(rec.scene.pose.cpu().numpy()[valid], poses[valid])
    out = {"phase": "stream", "card": card, "windows": len(windows),
           "seconds": {"per_window": [w["seconds"] for w in windows], "checkpoint": t_ck,
                       "restore": t_restore, "finalize": t_final, "total": total},
           "registered_per_window": [w["registered"] for w in windows],
           "new_pairs_per_window": [w["new_pairs"] for w in windows],
           "match_pairs_launches_per_window": [w["match_pairs_launches"] for w in windows],
           "registered": st["registered"], "landmarks": st["landmarks"], "ate": ate,
           "global_ba": st["global_ba"], "digest": scene_digest(rec.scene)}
    print(json.dumps(out), flush=True)
    require(st["registered"] >= N_FRAMES - 5, f"stream gate: {st['registered']} registered")
    require(ate < 0.1, f"stream gate: ATE {ate}")
    tidy(OUT / "stream")
    return out, captured


def check_kernel_at(tag, desc, kp_mask, pairs, record, card, launches=None, plain_reps=5,
                    profile=True):
    """The batched matcher held against its plain version on a phase's own
    inputs (three runs with equal bits), timed warm, cold (the first launch
    after the L2 was overwritten) and, with ``profile``, on the card alone
    under the profiler, beside the plain version and the bound; adds its
    numbers to the kernel's record under ``tag``. Without ``profile`` (a
    launch of milliseconds, where the wrapper's 0.1 ms of host work hides
    behind the previous launch) the warm mean is the card's time."""
    import torch
    from eacham_tpu_torch.ops import match_kernel as mk

    pairs = pairs.to(torch.int32).contiguous()
    desc_bf, m = mk.prepare(desc, kp_mask)
    P, Kp = pairs.shape[0], desc_bf.shape[1]
    raw_k = repeated(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), f"match kernel, {tag}")
    raw_p = mk.match_pairs_plain(desc_bf, m, pairs)
    equal = [bool(torch.equal(a, b)) for a, b in zip(raw_k, raw_p)]
    err = max(float((raw_k[i] - raw_p[i]).abs().max()) for i in (0, 2, 3, 5))
    _, vk = mk.decide(raw_k, m, pairs, BENCH_OPTIONS["match_ratio"])
    _, vp = mk.decide(raw_p, m, pairs, BENCH_OPTIONS["match_ratio"])
    agree = float((vk == vp).float().mean())
    same_j = bool(torch.equal(raw_k[1][vk & vp], raw_p[1][vk & vp]))
    live = int(m.any(1).sum())
    print(f"match kernel vs plain at the {tag} shape (table N={desc_bf.shape[0]} with "
          f"{live} live frames, Kp={Kp}, P={P} pairs), {REPEATS} equal runs: raw "
          f"equal {equal}, max |best/second diff| {err:.3g}, decision agreement {agree:.6f}, "
          f"valid {int(vk.sum())} kernel / {int(vp.sum())} plain", flush=True)
    require(all(equal) or (agree >= 0.999 and same_j),
            f"kernel disagrees with its plain version at the {tag} shape: {equal}, {agree}")
    ms = cuda_ms(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), reps=20)
    cold = cold_ms(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), desc_bf.device)
    dev_ms = (profiled_device_ms(lambda: mk.match_pairs_kernel(desc_bf, m, pairs),
                                 "match_pairs_kernel") if profile else None)
    plain_ms = cuda_ms(lambda: mk.match_pairs_plain(desc_bf, m, pairs), reps=plain_reps)
    # the work of this run: the products of P pairs, the table rows of the
    # frames the pairs touch read once, the outputs written once
    frames = int(torch.unique(pairs).numel())
    flops = 2.0 * P * Kp * Kp * desc_bf.shape[2]
    nbytes = (frames * Kp * (desc_bf.shape[2] * 2 + 1) + pairs.numel() * 4
              + sum(o.numel() * o.element_size() for o in raw_k))
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    # bucket_pairs pads with (0, 0) rows, which the kernel computes all the
    # same: the bound of the real pairs' products alone, beside it
    real = int((pairs[:, 0] < pairs[:, 1]).sum())
    real_bound_ms = max(flops * real / P / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    alone = "" if dev_ms is None else f", {dev_ms:.4f} ms on the card alone (profiler)"
    print(f"match kernel at the {tag} shape on {card}: {ms:.4f} ms a call warm (mean of "
          f"20, the wrapper's host work included){alone}, cold_ms {cold:.4f}, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP, "
          f"{nbytes:.4g} B); {real} of the {P} pairs real, their bound {real_bound_ms:.4f} ms",
          flush=True)
    require(ms >= bound_ms, f"match kernel {ms} ms is under its bound {bound_ms} ms")
    record[tag] = {"P": P, "Kp": Kp, "frames": frames, "table_rows": desc_bf.shape[0],
                   "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "cold_ms": cold,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "real_pairs": real, "real_bound_ms": real_bound_ms}
    if launches is not None:
        record[tag]["launches"] = launches


# ---- the sixth slice: the long-trajectory path -----------------------------------

# scripts/stress_500.py's recipe: the surface world on the radius-14 stress
# orbit (one turn and 4% more, so the tail revisits the start), K=1024, and
# its options (stress_500.py:116-131). Since the eleventh slice it runs at
# scripts/anchor_probe.py's 1000 frames, inside the ``anchors`` phase
# (ANCHOR_FRAMES, and its gate below); the 500-frame run is the same recipe
# at half the depth, and the script's time limit no longer holds both
LOOP_KPS, LOOP_EXTRACT_CHUNK = 1024, 500
LOOP_OPTIONS = dict(
    pair_window=10, pair_retrieval_k=3, max_observers=12,
    min_initial_inliers=80, min_matches=20, match_ratio=0.85,
    init_min_tri_angle_deg=0.8, min_tri_angle_deg=0.8,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=131072, refine_max_iters=30, global_max_iters=100,
    match_chunk=32, interim_ba_iters=10, loop_close=True, local_ba_every=1,
    local_ba_free_span=6, map_refine_rounds=-1, sweep_segment=128, ba_program_iters=10)
# the drift that the repair check puts on the finished trajectory: a smooth
# ramp (tests/test_submap.py's form) of up to 0.4 rad and 0.2 of the
# trajectory's radius (the reconstruction's scale is its own)
LOOP_DRIFT_ROT, LOOP_DRIFT_TRANS = 0.4, 0.2


def _render_frames(args):
    """A process pool's task: render the views ``poses`` of the scene at
    ``size`` (width, height)."""
    blobs, poses, intr, (width, height) = args
    from eacham_tpu_torch.utils.synthetic import render_view

    return np.stack([render_view(blobs, T, intr, width, height) for T in poses])


def render_workers() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def render_in_pool(tasks, workers: int) -> list:
    """``_render_frames`` over ``tasks`` in a pool of spawned processes;
    the results in the tasks' order."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_render_frames, tasks))


def render_loop_workload(n_frames: int, size=(WIDTH, HEIGHT)):
    """The stress recipe's ``n_frames`` frames at ``size`` (width,
    height), rendered by a pool of processes over the host's cores (untimed
    set-up). Returns (images, poses, intr, the number of processes)."""
    from eacham_tpu_torch.utils.synthetic import make_surface_scene, stress_orbit_poses

    f = 1.2 * max(size)
    intr = np.array([f, f, size[0] / 2, size[1] / 2], np.float32)
    blobs = make_surface_scene(np.random.default_rng(0), n_blobs=4000, jitter=0.05)
    poses = stress_orbit_poses(n_frames)
    workers = render_workers()
    tasks = [(blobs, poses[c], intr, size)
             for c in np.array_split(np.arange(n_frames), 4 * workers) if len(c)]
    return np.concatenate(render_in_pool(tasks, workers)), poses, intr, workers


def _ate(pose, valid, gt):
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    v = valid.cpu().numpy()
    return trajectory_ate(pose.cpu().numpy()[v], gt[v]) if v.sum() >= 3 else float("inf")


def run_loop(images, poses, intr, dev, card):
    """The long-trajectory path once: ``extract_features(K=1024)`` ->
    ``run_sfm`` with the stress recipe's options (windowed match graph with
    one ``match_pairs`` launch -> init pair -> sweep with interim BA ->
    loop-closing stage -> global BA and the three map-refinement rounds),
    launch counts set to 0 just before and read just after, held to the
    1000-frame gate (ANCHOR_MIN_REGISTERED, ANCHOR_MAX_ATE). The poses
    after the sweep and after the loop stage are read by wrapping the two
    stage functions. Returns (scene, stats, features, record)."""
    import torch
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm import pipeline as pl

    n = len(images)
    snaps, allocated = {}, {}
    close_loops, finalize = pl._close_loops, pl._finalize

    def at_loop(scene, *a, **k):
        snaps["sweep"] = (scene.pose.clone(), scene.pose_valid.clone())
        allocated["sweep"] = int(scene.n_landmarks)
        return close_loops(scene, *a, **k)

    def at_finalize(scene, *a, **k):
        snaps["loop"] = (scene.pose.clone(), scene.pose_valid.clone())
        allocated.setdefault("sweep", int(scene.n_landmarks))
        return finalize(scene, *a, **k)

    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    parts = []
    for lo in range(0, n, LOOP_EXTRACT_CHUNK):
        imgs = torch.as_tensor(images[lo:lo + LOOP_EXTRACT_CHUNK], device=dev)
        parts.append(extract_features(imgs, max_keypoints=LOOP_KPS, device=dev))
        del imgs
    xy, desc, mask = (torch.cat([p[i] for p in parts]) for i in (0, 1, 3))
    del parts
    sync(dev)
    t_extract = time.perf_counter() - t0
    pl._close_loops, pl._finalize = at_loop, at_finalize
    try:
        scene, stats = pl.run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                                  options=pl.SfmOptions(**ANCHOR_OPTIONS), verbose=True,
                                  device=dev)
    finally:
        pl._close_loops, pl._finalize = close_loops, finalize
    sync(dev)
    total = time.perf_counter() - t0
    launches = launch_counts()
    require(stats["initialized"], f"the loop phase found no init pair: {stats}")
    ate = {stage: _ate(*snaps[stage], poses) for stage in ("sweep", "loop") if stage in snaps}
    ate["final"] = _ate(scene.pose, scene.pose_valid, poses)
    sec = stats["seconds"]
    loop = stats.get("loop")
    rounds = stats["map_refine"]
    rec = {"phase": "loop", "card": card, "frames": n, "max_keypoints": LOOP_KPS,
           "seconds": dict(
               extract=t_extract, match_graph=sec["match_graph"],
               init=sec["init_pair"] + sec.get("seed", 0.0), sweep=sec["sweep"],
               loop=sec.get("loop"),
               loop_measure=loop["seconds"].get("measure") if loop else None,
               loop_submap=loop["seconds"].get("submap") if loop else None,
               loop_edges=loop["seconds"].get("edges") if loop else None,
               loop_solve=loop["seconds"].get("solve") if loop else None,
               loop_rebuild=loop["seconds"].get("rebuild") if loop else None,
               refine_rebuild=[r["seconds"]["rebuild"] for r in rounds],
               refine_ba=[r["seconds"]["ba"] for r in rounds],
               finalize=sec["finalize"], total=total),
           "pairs": stats["pairs"], "edges": stats["edges"], "init_pair": list(stats["init_pair"]),
           "registered": stats["registered"], "excluded": stats["excluded"],
           "landmarks": stats["landmarks"], "lm_capacity": scene.lm_capacity,
           "lm_allocated": dict(allocated, final=int(scene.n_landmarks)), "ate": ate,
           "loop": loop, "map_refine": rounds, "global_ba": stats["global_ba"],
           "match_pairs_launches": launches["match_pairs"], "digest": scene_digest(scene)}
    print(json.dumps(rec), flush=True)
    if loop is not None:
        print(f"loop stage: {loop['n_far']} long-range edges, {loop['loop_rows']} edges "
              f"measured, consistency {loop['err0']:.4f} deg after the sweep, decision "
              f"{loop['decision']}{' (submap applied)' if loop['submap'] else ''}", flush=True)
    require(launches["match_pairs"] == 1,
            f"the loop phase launched the matcher {launches['match_pairs']} times, not once")
    require(loop is not None and loop["n_far"] > 0 and loop["err0"] is not None,
            f"the loop stage was not entered: {loop}")
    require(len(rounds) == 3, f"{len(rounds)} map-refine rounds, not 3")
    require(bool(scene.pose.isfinite().all()) and bool(scene.points[scene.lm_valid].isfinite().all()),
            "the loop phase left non-finite poses or landmarks")
    require(stats["registered"] >= ANCHOR_MIN_REGISTERED,
            f"loop gate: {stats['registered']} of {n} frames registered")
    require(ate["final"] < ANCHOR_MAX_ATE, f"loop gate: ATE {ate['final']}")
    return scene, stats, (xy, desc, mask), rec


def check_drift_repair(scene, poses, dev, card, dump=None):
    """Both loop solvers on the card's own measurements of the finished
    scene: the loop PnP and edge measurements, a smooth drift ramp on the
    registered poses, then ``submap_align`` and ``optimize_pose_graph``
    with the loop stage's gates (the aligned submaps are kept below 0.75
    of the drifted consistency; the pose graph starts from what was kept
    and is accepted if it halves the consistency, or after kept submaps
    ends under the noise floor). Every solver output must be finite and
    what the gates keep no less consistent than the drifted poses.

    On this recipe's measurements neither solver halves the ramp's
    inconsistency, in the JAX package either (the same arrays replayed
    through both, scripts/loop_replay_{jax,torch}.py; SCALING.md's r4
    analysis of the reference's 500-frame run): the record says whether the
    kept poses halved it. ``dump``: a path to save the finished scene's
    poses and both measurement sets in, those scripts' input."""
    import torch
    from eacham_tpu_torch.device import to_numpy
    from eacham_tpu_torch.geometry.se3 import exp_se3
    from eacham_tpu_torch.sfm.pipeline import SfmOptions
    from eacham_tpu_torch.sfm.posegraph import (
        edge_measurements, loop_consistency, loop_pnp_measurements, optimize_pose_graph)
    from eacham_tpu_torch.sfm.submap import submap_align

    opt = SfmOptions(**LOOP_OPTIONS)
    g = torch.Generator(device=dev).manual_seed(11)
    pi = scene.pair_idx.cpu().numpy()
    span = np.abs(pi[:, 1].astype(np.int64) - pi[:, 0])
    rows = np.flatnonzero(scene.pair_ok.cpu().numpy() & (span > opt.pair_window))
    loop_rows = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    sync(dev)
    t = time.perf_counter()
    T_loop, w_loop = loop_pnp_measurements(
        scene.pose, scene.points, scene.lm_valid, scene.kp2lm, scene.keypoints,
        scene.pair_idx, scene.match_ij, scene.valid_ij, scene.intr, loop_rows, g,
        px_threshold=opt.max_repr_error, n_hyp=opt.ransac_hyps_pnp)
    sync(dev)
    t_measure = time.perf_counter() - t
    t = time.perf_counter()
    T_meas, w_meas = edge_measurements(
        scene.keypoints, scene.pair_idx, scene.pair_ok, scene.match_ij, scene.valid_ij,
        scene.intr, g, px_threshold=opt.max_repr_error)
    sync(dev)
    t_edges = time.perf_counter() - t
    args = (pi, rows, T_loop, w_loop)
    err_final = loop_consistency(scene.pose, *args)

    N = scene.pose.shape[0]
    valid = scene.pose_valid
    centers = to_numpy(scene.pose)[to_numpy(valid)]
    centers = -np.einsum("nij,ni->nj", centers[:, :3, :3], centers[:, :3, 3])
    radius = float(np.median(np.linalg.norm(centers - centers.mean(0), axis=1)))
    rng = np.random.default_rng(5)
    d6 = rng.normal(size=6)
    d6[:3] *= LOOP_DRIFT_ROT / np.linalg.norm(d6[:3])
    d6[3:] *= LOOP_DRIFT_TRANS * radius / np.linalg.norm(d6[3:])
    ramp = (np.arange(N) / N) ** 2
    drift = torch.as_tensor(ramp[:, None] * d6[None], dtype=torch.float32, device=dev)
    drifted = torch.where(valid[:, None, None], exp_se3(drift) @ scene.pose, scene.pose)
    err_drift = loop_consistency(drifted, *args)
    if dump:
        np.savez(dump, pose=to_numpy(scene.pose), pose_valid=to_numpy(scene.pose_valid),
                 pose_fixed=to_numpy(scene.pose_fixed), pair_idx=pi, rows=rows,
                 T_loop=to_numpy(T_loop), w_loop=to_numpy(w_loop), T_meas=to_numpy(T_meas),
                 w_meas=to_numpy(w_meas), drifted=to_numpy(drifted), gt=poses,
                 pgo_iters=opt.pgo_iters, submap_size=opt.submap_size)
        print(f"wrote the loop phase's measurements to {dump}", flush=True)
    t = time.perf_counter()
    pose_sub = submap_align(to_numpy(drifted), to_numpy(valid), to_numpy(scene.pose_fixed), pi,
                            rows, to_numpy(T_loop), to_numpy(w_loop), size=opt.submap_size)
    t_submap = time.perf_counter() - t
    err_sub = loop_consistency(pose_sub, *args)
    submap_kept = bool(err_sub < 0.75 * err_drift)
    start = torch.as_tensor(pose_sub, device=dev) if submap_kept else drifted
    err_start = err_sub if submap_kept else err_drift
    t = time.perf_counter()
    pose_pg = optimize_pose_graph(
        start, valid, scene.pose_fixed, pi, T_meas, w_meas,
        iters=opt.pgo_iters, loop_rows=loop_rows, T_loop=T_loop, w_loop=w_loop)
    sync(dev)
    t_pgo = time.perf_counter() - t
    err_pg = loop_consistency(pose_pg, *args)
    pgo_kept = bool(np.isfinite(err_pg) and (
        err_pg < 0.5 * err_start
        or (submap_kept and err_pg < min(err_start, opt.pgo_min_consistency_deg))))
    err_kept = err_pg if pgo_kept else err_start
    rec = {"radius": radius, "drift": d6.tolist(), "submap_kept": submap_kept,
           "pose_graph_kept": pgo_kept, "halved": bool(err_kept <= 0.5 * err_drift),
           "loop_rows": int(len(rows)), "live_loop_rows": int((to_numpy(w_loop) >= 30).sum()),
           "live_edges": int((to_numpy(w_meas) >= 20).sum()),
           "consistency_deg": {"final": err_final, "drifted": err_drift, "submap": err_sub,
                               "pose_graph": err_pg, "kept": err_kept},
           "ate": {"final": _ate(scene.pose, valid, poses), "drifted": _ate(drifted, valid, poses),
                   "submap": _ate(torch.as_tensor(pose_sub), valid, poses),
                   "pose_graph": _ate(pose_pg, valid, poses)},
           "seconds": {"loop_measure": t_measure, "edge_measure": t_edges,
                       "submap_align": t_submap, "optimize_pose_graph": t_pgo}}
    print(f"drift repair on {card}: " + json.dumps(rec), flush=True)
    require(np.isfinite(pose_sub).all() and bool(pose_pg.isfinite().all())
            and pose_pg.device == scene.pose.device and pose_pg.shape == scene.pose.shape,
            "a loop solver returned non-finite poses, or the pose graph left the card")
    require(np.isfinite(err_drift) and err_kept <= err_drift,
            f"drift repair: the gates kept a less consistent trajectory ({err_drift} -> "
            f"{err_sub} -> {err_pg} deg)")
    return rec


# ---- the seventh slice: metric RGB-D and stereo, the sharded paths, the API ------

# scripts/rgbd_recipe.py's TUM RGB-D and rectified stereo recipes on the
# bench's world; the metric pipeline takes the bench's options with the
# landmark capacity at its default N * K (scripts/rgbd_reference_jax.py
# runs the same recipes on the JAX package)
RGBD_KPS = 1024
RGBD_OPTIONS = dict(BENCH_OPTIONS, lm_capacity=None)
# the gate: at least 95 of 100 frames registered and the metric ATE (ground
# truth in frame 0's gauge, no scale and no rotation fitted) under a limit.
# The JAX package misses 0.1 on both recipes (scripts/rgbd_reference_jax.py
# on the CPU, PnP seeds 0-3: rgbd 0.6346, 0.7279, 0.7210, 0.7111; stereo
# 0.5349, 0.5060, 0.4651, 0.4282): frame-to-frame depth seeding drifts,
# and the recipe's depth rule gives a fifth of the keypoints a wrong depth.
# So each limit is 1.5x the largest of the reference's four figures.
RGBD_MAX_ATE = 1.5 * 0.7279
STEREO_MAX_ATE = 1.5 * 0.5349


def _recipe():
    sys.path.insert(0, str(ROOT / "scripts"))
    import rgbd_recipe

    return rgbd_recipe


def write_rgbd_workload(R, out: Path):
    """The TUM recipe's 100 frames and depth maps, written as a TUM
    directory (untimed set-up). Returns the ground-truth world->cam poses."""
    from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses, render_view

    W, H = R.TUM_SIZE
    blobs = make_blob_scene(np.random.default_rng(0), **R.BLOBS)
    poses = orbit_poses(R.N_FRAMES, **R.ORBIT)
    images = np.stack([render_view(blobs, T, R.TUM_INTR, W, H) for T in poses])
    depths = np.stack([R.noisy_depth(R.render_depth(blobs, T, R.TUM_INTR, W, H), i)
                       for i, T in enumerate(poses)])
    R.write_tum(out, images, depths, poses)
    return poses


def _metric_gate(tag, scene, stats, ate, limit, n):
    require(bool(scene.pose.isfinite().all()) and bool(scene.points[scene.lm_valid].isfinite().all()),
            f"the {tag} phase left non-finite poses or landmarks")
    require(stats["registered"] >= n - 5, f"{tag} gate: {stats['registered']} of {n} registered")
    require(ate < limit, f"{tag} gate: metric ATE {ate}")


def run_rgbd(R, dev, card, first=None):
    """The TUM RGB-D deployment once through the port's entry points:
    ``TumDataset.open`` -> ``load`` -> ``load_depth`` -> ``gt_for_frames`` ->
    ``extract_features(K=1024)`` -> ``depth_at_keypoints`` -> ``run_sfm_rgbd``,
    launch counts set to 0 just before and read just after; one JSON line,
    the gate. The first run writes the TUM directory; a run given ``first``,
    an earlier run's ``(scene, stats)``, reads the same directory again,
    must repeat that run bit for bit, and removes the frames. Returns
    (desc, mask, scene, matcher launches, stats)."""
    import torch
    from eacham_tpu_torch.features import extract_features
    from eacham_tpu_torch.io.datasets import TumDataset
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions
    from eacham_tpu_torch.sfm.rgbd import depth_at_keypoints, run_sfm_rgbd

    out = OUT / "rgbd"
    t_render = None
    if first is None:
        t0 = time.perf_counter()
        write_rgbd_workload(R, out)
        t_render = time.perf_counter() - t0
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    ds = TumDataset.open(out)
    batch = ds.load()
    depth, has = ds.load_depth()
    gt_c2w, gt_ok = ds.gt_for_frames()
    t_load = time.perf_counter() - t0
    t = time.perf_counter()
    xy, desc, _, mask = extract_features(batch.images, max_keypoints=RGBD_KPS, device=dev)
    sync(dev)
    t_extract = time.perf_counter() - t
    t = time.perf_counter()
    kp_z = depth_at_keypoints(depth, xy, device=dev)
    sync(dev)
    t_depth = time.perf_counter() - t
    scene, stats = run_sfm_rgbd(xy, desc, mask, kp_z, R.TUM_INTR,
                                options=SfmOptions(**RGBD_OPTIONS), verbose=False, device=dev)
    sync(dev)
    total = time.perf_counter() - t0
    launches = launch_counts()
    valid = scene.pose_valid.cpu().numpy()
    ate = R.metric_ate(scene.pose.cpu().numpy(), np.linalg.inv(gt_c2w), valid)
    live_z = float(((kp_z > 0) & mask).sum() / mask.sum())
    differ = [] if first is None else same_reconstruction(first, (scene, stats))
    rec = {"phase": "rgbd", "run": int(first is not None), "card": card,
           "frames": len(batch.names),
           "size": list(R.TUM_SIZE), "max_keypoints": RGBD_KPS, "decoder": batch.backend,
           "seconds": dict(render_untimed=t_render, load=t_load, extract=t_extract,
                           depth=t_depth, **stats["seconds"], total=total),
           "frames_per_s": len(batch.names) / total, "depth_frames": int(has.sum()),
           "gt_frames": int(gt_ok.sum()), "keypoints_with_depth": live_z,
           "registered": stats["registered"], "landmarks": stats["landmarks"],
           "metric_ate": ate, "global_ba": stats["global_ba"],
           "match_pairs_launches": launches["match_pairs"], "digest": scene_digest(scene),
           **({} if first is None else {"repeat_equal": not differ})}
    print(json.dumps(rec), flush=True)
    require(not differ, f"the rgbd phase's second run differs from its first in {differ}")
    require(batch.images.shape == (N_FRAMES, R.TUM_SIZE[1], R.TUM_SIZE[0]), batch.images.shape)
    require(bool(has.all()) and bool(gt_ok.all()), "a frame lost its depth or ground truth")
    require(launches["match_pairs"] == 1,
            f"the rgbd phase launched the matcher {launches['match_pairs']} times, not once")
    _metric_gate("rgbd", scene, stats, ate, RGBD_MAX_ATE, N_FRAMES)
    if first is not None:
        import shutil

        for d in ("rgb", "depth"):          # the passed phase's frames and depth maps
            shutil.rmtree(out / d, ignore_errors=True)
    return desc, mask, scene, launches["match_pairs"], stats


def run_stereo(R, images, poses, intr, dev, card):
    """The rectified stereo deployment once: the bench's 100 frames as left
    views, right views ``STEREO_BASELINE`` along each camera's x axis, both
    through ``extract_features(K=512)``, one ``features.match_pair(left,
    right)`` a frame (kernel 1 at P=1), the row and disparity filter,
    ``stereo_depth_at_keypoints`` -> ``run_sfm_rgbd``; launch counts set to
    0 just before and read just after the stereo pairs and after the run.
    Returns what the kernel checks need, with the stereo pairs' launches."""
    import torch
    from eacham_tpu_torch.features import extract_features, match_pair
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions
    from eacham_tpu_torch.sfm.rgbd import run_sfm_rgbd, stereo_depth_at_keypoints
    from eacham_tpu_torch.utils.synthetic import make_blob_scene, render_view

    t0 = time.perf_counter()
    blobs = make_blob_scene(np.random.default_rng(0), **R.BLOBS)
    right = np.stack([render_view(blobs, R.right_pose(T), intr, WIDTH, HEIGHT) for T in poses])
    t_render = time.perf_counter() - t0
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    xy, desc, _, mask = extract_features(images, max_keypoints=MAX_KPS, device=dev)
    xr, dr, _, mr = extract_features(right, max_keypoints=MAX_KPS, device=dev)
    sync(dev)
    t_extract = time.perf_counter() - t0
    t = time.perf_counter()
    right_x = torch.zeros_like(xy[..., 0])
    keep = torch.zeros_like(mask)
    for i in range(N_FRAMES):
        j, v = match_pair(desc[i], dr[i], mask[i], mr[i], ratio=BENCH_OPTIONS["match_ratio"])
        matched = xr[i][j.long()]
        keep[i] = R.stereo_keep(xy[i], matched, v)
        right_x[i] = matched[:, 0]
    sync(dev)
    t_match = time.perf_counter() - t
    pair_launches = launch_counts()["match_pairs"]
    kp_z = stereo_depth_at_keypoints(xy, right_x, intr, R.STEREO_BASELINE, device=dev) * keep
    scene, stats = run_sfm_rgbd(xy, desc, mask, kp_z, intr,
                                options=SfmOptions(**RGBD_OPTIONS), verbose=False, device=dev)
    sync(dev)
    total = time.perf_counter() - t0
    launches = launch_counts()
    valid = scene.pose_valid.cpu().numpy()
    ate = R.metric_ate(scene.pose.cpu().numpy(), poses, valid)
    rec = {"phase": "stereo", "card": card, "frames": N_FRAMES, "size": [WIDTH, HEIGHT],
           "max_keypoints": MAX_KPS, "baseline": R.STEREO_BASELINE,
           "seconds": dict(render_right_untimed=t_render, extract_both=t_extract,
                           stereo_match=t_match, **stats["seconds"], total=total),
           "stereo_matches_per_frame": float(keep.sum(1).float().mean()),
           "registered": stats["registered"], "landmarks": stats["landmarks"],
           "metric_ate": ate, "global_ba": stats["global_ba"],
           "match_pairs_launches": launches["match_pairs"],
           "stereo_pair_launches": pair_launches,
           "match_pair_launches": launches["match_pair"], "digest": scene_digest(scene)}
    print(json.dumps(rec), flush=True)
    require(pair_launches == N_FRAMES and launches["match_pairs"] == N_FRAMES + 1
            and launches["match_pair"] == 0,
            f"the stereo phase's launches {launches}: want {N_FRAMES + 1} of match_pairs "
            "(one a stereo pair, one for the match graph) and none of match_pair")
    require(int(keep.sum(1).min()) >= 20, "a frame has fewer than 20 stereo matches")
    _metric_gate("stereo", scene, stats, ate, STEREO_MAX_ATE, N_FRAMES)
    return desc, mask, dr, mr, scene, pair_launches


def check_match_pair_padding(desc, dr, mask, mr):
    """``match_pair`` on two sets of different size (K1=200, K2=150 of the
    512 slots of frame 0's left and right features, so its table pads to
    Kp=256) must give the same bits as the same pair inside the batched call
    on the full two-row table (Kp=512, the cut slots masked): padding moves
    neither the quantization nor the live lanes' indices."""
    import torch
    from eacham_tpu_torch.features import match_all_pairs, match_pair

    K1, K2 = 200, 150
    m1, m2 = mask[0].clone(), mr[0].clone()
    m1[K1:], m2[K2:] = False, False
    j, v = match_pair(desc[0, :K1], dr[0, :K2], m1[:K1], m2[:K2])
    table = torch.stack([desc[0], dr[0]])
    jb, vb, _ = match_all_pairs(table, torch.stack([m1, m2]),
                                torch.tensor([[0, 1]], dtype=torch.int32, device=desc.device),
                                min_matches=0)
    same = bool(torch.equal(v, vb[0, :K1])) and bool(torch.equal(j[v], jb[0, :K1][v]))
    print(f"match_pair padding check (K1={K1}, K2={K2}, Kp 256 against 512): "
          f"{int(v.sum())} matches, equal to the batched call's: {same}", flush=True)
    require(same and int(v.sum()) > 0, "match_pair differs from the same pair in a batched call")


def check_stereo_kernel(desc, mask, dr, mr, launches, record, card):
    """Kernel 1 at the stereo phase's P=1 shape (frame 0's left and right
    features as the two-row table ``match_pair`` builds): held against its
    plain version (three runs with equal bits), a call's time, the card's
    time alone under the profiler, the bound; and one call of the public
    ``match_pair`` itself."""
    import torch
    from eacham_tpu_torch.features import match_pair

    table = torch.stack([desc[0], dr[0]])
    tmask = torch.stack([mask[0], mr[0]])
    pair = torch.tensor([[0, 1]], dtype=torch.int32, device=desc.device)
    check_kernel_at("stereo", table, tmask, pair, record, card, launches=launches)
    call_ms = cuda_ms(lambda: match_pair(desc[0], dr[0], mask[0], mr[0]), reps=50)
    rec = record["stereo"]
    rec["match_pair_call_ms"] = call_ms
    host = 1.0 - rec["device_ms"] / call_ms
    print(f"match_pair (P=1) on {card}: {call_ms:.4f} ms a call of the public entry point "
          f"(mean of 50), {rec['ms']:.4f} ms a call of the kernel's wrapper, "
          f"{rec['device_ms']:.4f} ms on the card alone: the host's share of a call "
          f"{host:.3f}", flush=True)


def run_parallel(desc, mask, scene, dev, card):
    """The sharded paths on the one card: a process group of one rank over
    NCCL (a ``file://`` store under chiprun_out/), then the bench's P=5120
    match through ``match_all_pairs_sharded`` against ``match_all_pairs``,
    and the first ``run_sfm`` scene's global BA through
    ``refine_ba_sharded`` and through ``_ba`` on the mesh (its scene state
    broadcast) against the unsharded calls, all with equal bits required,
    and no deterministic mode on: the BA's sums run in a fixed order by
    construction. Two ranks on one card cannot share NCCL; the two-rank
    logic is held by the CPU gloo tests."""
    import torch
    import torch.distributed as dist
    from eacham_tpu_torch.features import match_all_pairs
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.parallel import (
        init_distributed, make_mesh, match_all_pairs_sharded, refine_ba_sharded)
    from eacham_tpu_torch.sfm import pipeline as pl
    from eacham_tpu_torch.sfm.matches import all_pairs_index, bucket_pairs
    from eacham_tpu_torch.sfm.scene import ba_problem_counts, ba_problem_windowed
    from eacham_tpu_torch.ba.core import refine_ba

    out = OUT / "parallel"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    multi = init_distributed(f"file://{store}", 1, 0, device=dev)
    mesh = make_mesh(1, device=dev)
    t_init = time.perf_counter() - t0
    backend = dist.get_backend()
    require(not multi and mesh.group is not None
            and backend == ("nccl" if dev.type == "cuda" else "gloo"),
            f"process group: multi {multi}, backend {backend}")
    opt = pl.SfmOptions(**BENCH_OPTIONS)
    pairs = torch.as_tensor(bucket_pairs(all_pairs_index(desc.shape[0])), device=dev)
    sync(dev)
    reset_launch_counts()
    t = time.perf_counter()
    sharded = match_all_pairs_sharded(desc, mask, pairs, mesh, ratio=opt.match_ratio,
                                      min_matches=opt.min_matches)
    sync(dev)
    t_match = time.perf_counter() - t
    launches = launch_counts()
    single = match_all_pairs(desc, mask, pairs, ratio=opt.match_ratio,
                             min_matches=opt.min_matches)
    match_equal = all(bool(torch.equal(a, b)) for a, b in zip(sharded, single))

    _, global_cfg = pl._ba_configs(opt)
    N, K = scene.kp_mask.shape
    n_obs, n_lms = torch.stack(ba_problem_counts(scene, scene.pose_valid)).tolist()
    prob = ba_problem_windowed(scene, scene.pose_valid, max_cams=N,
                               max_obs=pl._bucket(n_obs, N * K),
                               max_lms=pl._bucket(n_lms, scene.lm_capacity))[0]
    deterministic_mode = torch.are_deterministic_algorithms_enabled()
    a = refine_ba(prob, global_cfg)
    sync(dev)
    t = time.perf_counter()
    b = refine_ba_sharded(prob, global_cfg, mesh)
    sync(dev)
    t_ba = time.perf_counter() - t
    c = refine_ba(prob, global_cfg)
    s1, i1 = pl._ba(scene, scene.pose_valid, global_cfg, opt.min_ba_landmarks)
    s2, i2 = pl._ba(scene, scene.pose_valid, global_cfg, opt.min_ba_landmarks, mesh=mesh)
    same = lambda x, y: all(bool(torch.equal(u, v)) for u, v in zip(x[:3], y[:3]))
    ba_equal, repeat_equal = same(a, b), same(a, c)
    pipe_equal = (bool(torch.equal(s1.pose, s2.pose)) and bool(torch.equal(s1.points, s2.points))
                  and i1["iterations"] == i2["iterations"])
    # the ranks' meeting point of the replicated stages (the whole scene,
    # ``excluded`` and two flags) over NCCL: rank 0 of one gets its own back
    excluded = scene.pose_valid.logical_not()
    s3, ex3, flags = pl.sync_ranks(mesh, scene, excluded, 7, 1, fields=type(scene)._fields)
    sync_equal = (all(bool(torch.equal(u, v)) for u, v in zip(scene, s3))
                  and bool(torch.equal(ex3, excluded)) and flags == [7, 1])
    dist.destroy_process_group()
    rec = {"phase": "parallel", "card": card, "backend": backend, "world_size": 1,
           "pairs": int(pairs.shape[0]), "ba_observations": int(prob.obs_cam.shape[0]),
           "ba_iterations": b[3]["iterations"],
           "seconds": {"init_distributed": t_init, "match_sharded": t_match,
                       "refine_ba_sharded": t_ba},
           "match_equal": match_equal, "refine_ba_equal": ba_equal,
           "refine_ba_repeat_equal": repeat_equal, "pipeline_ba_equal": pipe_equal,
           "sync_ranks_equal": sync_equal, "deterministic_mode": deterministic_mode,
           "match_pairs_launches": launches["match_pairs"]}
    print(json.dumps(rec), flush=True)
    require(not deterministic_mode, "a deterministic mode is on")
    require(launches["match_pairs"] == 1, f"the sharded match launched {launches}")
    require(match_equal, "match_all_pairs_sharded differs from match_all_pairs")
    require(repeat_equal, "refine_ba differs from itself on the same problem")
    require(ba_equal and pipe_equal, "the sharded BA differs from the unsharded one")
    require(sync_equal, "sync_ranks over NCCL changed rank 0's own state")


def run_api(images, dev, card):
    """The public per-image frontend and the utilities on the card:
    ``detect_keypoints`` + ``describe_keypoints`` on frame 0 against
    ``extract_features`` on the same frame, ``ClassicalFrontend(512,
    batch=8)`` on the 100 frames against ``extract_features`` on them (equal
    bits required), ``device_trace`` around one ``match_pair`` call (a trace
    file with device activity) and ``memory_summary`` naming the card."""
    import torch
    from eacham_tpu_torch.features import (
        ClassicalFrontend, describe_keypoints, detect_keypoints, extract_features, match_pair)
    from eacham_tpu_torch.utils import device_trace, memory_summary

    t0 = time.perf_counter()
    xy0, sidx0, score0, m0 = detect_keypoints(images[0], max_keypoints=MAX_KPS, device=dev)
    d0 = describe_keypoints(images[0], xy0, sidx0, m0, device=dev)
    sync(dev)
    t_single = time.perf_counter() - t0
    one = extract_features(images[:1], max_keypoints=MAX_KPS, device=dev)
    per_image_equal = all(bool(torch.equal(a, b[0])) for a, b in zip((xy0, d0, score0, m0),
                                                                       (one[0], one[1], one[2], one[3])))
    t0 = time.perf_counter()
    front = ClassicalFrontend(max_keypoints=MAX_KPS, batch=8, device=dev)(images)
    sync(dev)
    t_front = time.perf_counter() - t0
    whole = extract_features(images, max_keypoints=MAX_KPS, device=dev)
    front_equal = all(bool(torch.equal(a, b)) for a, b in zip(front, whole))
    batch_equal = all(bool(torch.equal(a, b[0])) for a, b in zip((xy0, d0, score0, m0),
                                                                  (whole[0], whole[1], whole[2],
                                                                   whole[3])))
    trace_dir = OUT / "api" / "trace"
    with device_trace(trace_dir):
        match_pair(whole[1][0], whole[1][1], whole[3][0], whole[3][1])
    traces = sorted(trace_dir.glob("trace-*.json"))
    trace_kernels = 0
    if traces:
        events = json.loads(traces[-1].read_text()).get("traceEvents", [])
        trace_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    mem = memory_summary()
    rec = {"phase": "api", "card": card,
           "seconds": {"detect_describe_frame0": t_single, "classical_frontend_100": t_front},
           "per_image_equals_extract_features": per_image_equal,
           "per_image_equals_batched_frame0": batch_equal,
           "classical_frontend_equals_extract_features": front_equal,
           "trace_files": len(traces), "trace_kernel_events": trace_kernels,
           "memory_summary": mem}
    print(json.dumps(rec), flush=True)
    require(per_image_equal, "detect/describe_keypoints differ from extract_features on frame 0")
    require(front_equal, "ClassicalFrontend differs from extract_features")
    require(len(traces) == 1 and trace_kernels > 0, "device_trace wrote no trace with kernels")
    require(torch.cuda.get_device_name(0) in mem, f"memory_summary does not name the card: {mem}")
    for f in traces:
        f.unlink()


# ---- the eighth slice: training the deep frontend -----------------------------

# scripts/train_deep.py's recipes: train_lightglue (3 layers, batch 8, 64
# keypoints, lr 3e-4) from init_params, here 120 updates; train_superpoint
# (batch 8, 160x120, the blob world, lr 1e-3) a few updates from init_params
# and a head-only run from the shipped weights. scripts/train_mix_driver.sh's
# fine-tune: train_lightglue_sp from the shipped SuperPoint and LightGlue on
# the mix of worlds, 256 keypoints at 224x168, batch 8, lr 2e-4, 3 render
# workers, first seed 1000 (its first chunk's).
TRAIN_LG = dict(steps=120, batch=8, lr=3e-4, n_layers=3, n_kps=64, seed=0)
TRAIN_MIX = dict(steps=16, batch=8, lr=2e-4, n_kps=256, width=224, height=168, world="mix",
                 workers=3, seed=1000)
TRAIN_SP = dict(batch=8, lr=1e-3, width=160, height=120)
TRAIN_SP_STEPS, TRAIN_HEAD_STEPS = 4, 3
TRAIN_LG_WINDOWS = ((10, 20), (30, 40))     # both inside the clean first third (steps // 3)
# kernel 3 in training: the loss and every gradient with the kernel's forward
# pass against the plain forward pass (the backward is the same einsums)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3


def weights_digest() -> dict:
    """sha256 of the shipped weight files (weights/*.npz, lightglue.meta)."""
    import hashlib

    wdir = ROOT / "weights"
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(wdir.iterdir()) if p.suffix in (".npz", ".meta")}


def _mean(xs, lo, hi):
    return float(np.mean(xs[lo:hi]))


def run_train(dev, card):
    """The training path at full width: ``train_lightglue``,
    ``train_lightglue_sp`` on the mix with a render pool, ``save_params`` and
    the reload through ``load_frontend_params``, ``train_superpoint`` from
    ``init_params`` and head-only from the shipped weights. Each trainer is
    driven with the launch counts set to 0 just before it and read just
    after. Returns what the kernel check needs: the two trained matchers,
    step 0's and step 2's mix batches, a ``synthetic_matches`` batch and the
    launches."""
    import copy

    import torch
    from eacham_tpu_torch import ops
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep import train
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params
    from eacham_tpu_torch.utils import timer

    before = weights_digest()
    t_phase = time.perf_counter()
    out = OUT / "train"
    out.mkdir(parents=True, exist_ok=True)

    # 1. train_lightglue from init_params
    timer.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg_model, lg_losses = train.train_lightglue(
        log_every=0, device=dev, generator=torch.Generator().manual_seed(TRAIN_LG["seed"]),
        **TRAIN_LG)
    sync(dev)
    lg_secs = time.perf_counter() - t0
    lg_launches = ops.launch_counts()
    lg_split = {k.split("/")[1]: [ms / 1e3 for ms in v] for k, v in timer.stats().items()
                if k.startswith("train_lg/")}
    (a, b), (c, d) = TRAIN_LG_WINDOWS
    early, late = _mean(lg_losses, a, b), _mean(lg_losses, c, d)

    # 2. train_lightglue_sp: the shipped models on the mix, render pool of 3
    superpoint, matcher, n_layers = load_frontend_params(device=dev)
    kept, labels = {}, []
    inner = train.make_sp_batch

    def record(*args, **kw):
        out_b = inner(*args, **kw)
        labels.append(((out_b[6] >= 0).sum(1), out_b[2].sum(1)))
        if len(labels) - 1 in (0, 2):
            kept[len(labels) - 1] = out_b
        return out_b

    timer.reset_stats()
    ops.reset_launch_counts()
    train.make_sp_batch = record
    t0 = time.perf_counter()
    try:
        mix_model, mix_losses = train.train_lightglue_sp(
            superpoint, params=matcher, n_layers=n_layers, log_every=0, device=dev, **TRAIN_MIX)
    finally:
        train.make_sp_batch = inner
    sync(dev)
    mix_secs = time.perf_counter() - t0
    mix_launches = ops.launch_counts()
    split = {k.split("/")[1]: [ms / 1e3 for ms in v] for k, v in timer.stats().items()
             if k.startswith("train_sp/")}

    lg.save_params(out / "superpoint.npz", superpoint)
    lg.save_params(out / "lightglue.npz", mix_model)
    (out / "lightglue.meta").write_text(f"n_layers={n_layers}\n")
    sp_back, lg_back, layers_back = load_frontend_params(weights_dir=out, device=dev)
    reload_equal = (layers_back == n_layers and all(
        torch.equal(p, q) for m, r in ((superpoint, sp_back), (mix_model, lg_back))
        for p, q in zip(m.parameters(), r.parameters())))

    # 3. train_superpoint from init_params, then head-only from the shipped weights
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, sp_losses = train.train_superpoint(
        steps=TRAIN_SP_STEPS, seed=0, log_every=0, device=dev,
        generator=torch.Generator().manual_seed(0), **TRAIN_SP)
    head, head_losses = train.train_superpoint(
        steps=TRAIN_HEAD_STEPS, seed=1, params=superpoint, trainable={"det1", "det2"},
        anchor_params=superpoint, log_every=0, device=dev, **TRAIN_SP)
    sync(dev)
    sp_secs = time.perf_counter() - t0
    sp_launches = ops.launch_counts()
    frozen_equal = {name: all(torch.equal(p, q) for p, q in zip(
        getattr(head, name).parameters(), getattr(superpoint, name).parameters()))
        for name in ("backbone", "desc1", "desc2", "det1", "det2")}
    # the anchor term at the head-only run's step 0: its first batch, its start
    step0 = train.make_batch(np.random.default_rng(1), batch=TRAIN_SP["batch"],
                             width=TRAIN_SP["width"], height=TRAIN_SP["height"])
    with torch.no_grad():
        _, aux0 = train._sp_loss(copy.deepcopy(superpoint), *train._as(step0[:5], dev),
                                 anchor_params=superpoint)
    anchor0 = aux0["anchor"].item()

    after = weights_digest()
    steps = TRAIN_MIX["steps"]
    n_pairs = np.concatenate([lab[0] for lab in labels])
    n_live = np.concatenate([lab[1] for lab in labels])
    rec = {"phase": "train", "card": card,
           "train_lightglue": {
               "steps": TRAIN_LG["steps"], "seconds": lg_secs,
               "seconds_per_step": lg_secs / TRAIN_LG["steps"],
               "batch_s_per_step": float(np.mean(lg_split["batch"])),
               "step_s_first": lg_split["step"][0],
               "step_s_per_step_after_first": float(np.mean(lg_split["step"][1:])),
               "loss_step0": lg_losses[0],
               f"mean_loss_{a}_{b - 1}": early, f"mean_loss_{c}_{d - 1}": late,
               "loss_last": lg_losses[-1], "launches": lg_launches},
           "train_lightglue_sp": {
               "steps": steps, "seconds": mix_secs, "seconds_per_step": mix_secs / steps,
               "render_wait_s_per_step": float(np.mean(split["render_wait"])),
               "render_wait_first_s": split["render_wait"][0],
               "batch_s_per_step": float(np.mean(split["batch"])),
               "step_s_per_step": float(np.mean(split["step"])),
               "labels_per_pair": float(n_pairs.mean()), "live_kps_per_view0": float(n_live.mean()),
               "losses": mix_losses, "launches": mix_launches, "reload_bit_equal": reload_equal},
           "train_superpoint": {
               "steps": TRAIN_SP_STEPS, "losses": sp_losses, "head_steps": TRAIN_HEAD_STEPS,
               "head_losses": head_losses, "seconds": sp_secs, "frozen_bit_equal": frozen_equal,
               "anchor_step0": anchor0, "launches": sp_launches},
           "weights_unchanged": before == after,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(rec), flush=True)
    require(lg_launches["masked_attention"] == 12 * TRAIN_LG["steps"],
            f"train_lightglue launched attention {lg_launches}, want {12 * TRAIN_LG['steps']}")
    require(np.isfinite(lg_losses).all() and late < early,
            f"train_lightglue's loss did not fall over the clean third: {early} -> {late}")
    require(mix_launches["masked_attention"] == 4 * n_layers * steps,
            f"train_lightglue_sp launched attention {mix_launches}, want {4 * n_layers * steps}")
    require(len(mix_losses) == steps and np.isfinite(mix_losses).all(),
            f"train_lightglue_sp losses {mix_losses}")
    require(reload_equal, "the saved weights did not reload bit for bit")
    require(np.isfinite(sp_losses).all() and np.isfinite(head_losses).all(),
            f"train_superpoint losses {sp_losses} {head_losses}")
    require(all(frozen_equal[n] for n in ("backbone", "desc1", "desc2"))
            and not frozen_equal["det1"], f"head-only run: modules bit-equal {frozen_equal}")
    require(anchor0 == 0.0, f"the anchor term reads {anchor0} at step 0")
    require(before == after, "weights/ changed during the train phase")
    for f in out.glob("*.npz"):
        f.unlink()
    lg_batch = train.synthetic_matches(np.random.default_rng(TRAIN_LG["seed"]), TRAIN_LG["batch"],
                                       TRAIN_LG["n_kps"], 0.1, 0.0)
    return {"lg_model": lg_model, "matcher": matcher, "mix_model": mix_model, "kept": kept,
            "lg_batch": lg_batch, "step0_loss": mix_losses[0],
            "launches": lg_launches["masked_attention"] + mix_launches["masked_attention"]}


def _loss_and_grads(model, batch, dev, loss_fn):
    """loss and every parameter's gradient (zeros where the loss does not
    reach one) of ``loss_fn`` on a copy of ``model``."""
    import copy

    import torch
    from eacham_tpu_torch.features.deep import train

    m = copy.deepcopy(model).requires_grad_(True)
    loss, _ = loss_fn(m, *train._as(batch, dev))
    loss.backward()
    return loss.detach(), [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                           for p in m.parameters()], [n for n, _ in m.named_parameters()]


def check_train_kernel(art, record, card):
    """Kernel 3 in training on the card: on step 2's mix batch, the loss and
    every gradient of the fine-tuned matcher with the kernel's forward pass
    (three runs) against the plain forward pass; the card's step-0 loss
    against the CPU's plain one on the same start and batch; the kernel
    timed at the two training shapes with their own inputs. Adds
    ``record["train"]``."""
    import copy

    import torch
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep import train
    from eacham_tpu_torch.ops import attention as at

    model, batch = art["mix_model"], art["kept"][2]
    dev = next(model.parameters()).device
    kernel_fwd = at.masked_attention
    runs = [_loss_and_grads(model, batch, dev, train.lightglue_sp_loss) for _ in range(REPEATS)]
    runs_equal = all(bool(torch.equal(r[0], runs[0][0])) and all(
        torch.equal(g, h) for g, h in zip(r[1], runs[0][1])) for r in runs[1:])
    at.masked_attention = at.masked_attention_plain
    try:
        plain = _loss_and_grads(model, batch, dev, train.lightglue_sp_loss)
    finally:
        at.masked_attention = kernel_fwd
    loss_k, grads_k, names = runs[0]
    loss_rel = abs(loss_k.item() - plain[0].item()) / abs(plain[0].item())
    top = max(float(g.abs().max()) for g in plain[1])
    worst, worst_name = 0.0, None
    for name, gk, gp in zip(names, grads_k, plain[1]):
        if name.startswith("cross") and name.endswith(".k.bias"):
            # zero in exact arithmetic (the softmax of a row does not see one
            # constant added to all its scores): rounding noise on both sides
            require(max(float(gk.abs().max()), float(gp.abs().max())) < 1e-5 * top,
                    f"{name}: gradient {float(gk.abs().max())} is more than rounding noise")
            continue
        rel = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    # step 0's loss: the card's run against the CPU's plain version on the
    # shipped start and the same batch
    cpu_loss, _ = train.lightglue_sp_loss(copy.deepcopy(art["matcher"]).cpu(),
                                          *train._as(art["kept"][0], "cpu"))
    step0_rel = abs(art["step0_loss"] - cpu_loss.item()) / abs(cpu_loss.item())
    print(f"kernel 3 in training on {card}: step 2's mix batch, loss kernel "
          f"{loss_k.item():.7f} / plain {plain[0].item():.7f} (rel {loss_rel:.3g}, limit "
          f"{TRAIN_LOSS_RTOL}), worst gradient {worst:.3g} of its max-abs ({worst_name}; limit "
          f"{TRAIN_GRAD_TOL}), {REPEATS} kernel runs equal: {runs_equal}; step-0 loss card "
          f"{art['step0_loss']:.7f} / CPU plain {cpu_loss.item():.7f} (rel {step0_rel:.3g})",
          flush=True)
    require(loss_rel < TRAIN_LOSS_RTOL and worst < TRAIN_GRAD_TOL,
            f"kernel-forward training differs from the plain forward: {loss_rel}, {worst}")
    require(step0_rel < TRAIN_LOSS_RTOL, f"step-0 loss card vs CPU off by {step0_rel}")

    # the kernel at the training shapes, on inputs the matchers make
    shapes = {}
    for tag, net, b in (("mix", model, batch), ("synthetic", art["lg_model"], art["lg_batch"])):
        seen = []
        inner = lg.attention

        def grab(q, k, v, m):
            seen.append((q, k, v, m))
            return inner(q, k, v, m)

        lg.attention = grab
        try:
            with torch.no_grad():
                t = train._as(b, dev)
                if tag == "mix":
                    net.similarity(t[0], t[1], t[2], t[3], t[4], t[5])
                else:
                    ones = torch.ones(t[0].shape[:2], dtype=torch.bool, device=dev)
                    net.similarity(t[0], t[1], ones, t[2], t[3], ones)
        finally:
            lg.attention = inner
        # the first self block
        shapes[tag] = time_attention(*seen[0], card, f"train {tag}")
    record["train"] = {"launches": art["launches"], "launches_per_step": 12,
                       "loss_rel": loss_rel, "grad_rel": worst, "kernel_runs_equal": runs_equal,
                       "step0_loss_rel_cpu": step0_rel, **shapes}


# ---- the tenth slice: the deep path to its end -----------------------------

# scripts/bench_deep.py's worlds: blob fields from seeds 0-4 on the bench's
# orbit (world 0 is render_workload()'s), and its gate (bench_deep.py:172-174):
# every world at least 95 of 100 frames registered, the median ATE under 0.1
DEEP_WORLDS = 5
DEEP_SFM_MIN_REGISTERED, DEEP_SFM_MAX_MEDIAN_ATE = N_FRAMES - 5, 0.1


def deep_world(seed: int, n_frames: int = N_FRAMES):
    """The deep bench's world ``seed``: its blob field, its orbit of
    ``n_frames`` poses and the camera (scripts/bench_deep.py's recipe).
    Returns (blobs, poses, intr)."""
    from eacham_tpu_torch.utils.synthetic import make_blob_scene, orbit_poses

    f = 1.2 * max(WIDTH, HEIGHT)
    intr = np.array([f, f, WIDTH / 2, HEIGHT / 2], np.float32)
    poses = orbit_poses(n_frames, radius=0.6, step_deg=0.5, advance=0.03)
    blobs = make_blob_scene(np.random.default_rng(seed), n_blobs=900, depth=(3.5, 9.0),
                            spread=2.6)
    return blobs, poses, intr


def render_views(worlds):
    """Each ``(blobs, poses, intr)`` of ``worlds`` rendered by a pool of
    processes over the host's cores (untimed set-up). Returns (a list of
    [n, H, W] image arrays, the number of processes)."""
    workers = render_workers()
    tasks, spans = [], []
    for blobs, poses, intr in worlds:
        chunks = [c for c in np.array_split(np.arange(len(poses)), workers) if len(c)]
        spans.append((len(tasks), len(tasks) + len(chunks)))
        tasks += [(blobs, poses[c], intr, (WIDTH, HEIGHT)) for c in chunks]
    parts = render_in_pool(tasks, workers)
    return [np.concatenate(parts[a:b]) for a, b in spans], workers


def render_deep_worlds():
    """Worlds 1..DEEP_WORLDS-1 of the deep bench (``render_views``)."""
    return render_views([deep_world(w) for w in range(1, DEEP_WORLDS)])


def run_deep_world(models, images, intr, poses, dev, card, world, first=None, dump=None):
    """One world of the deep bench through the port's entry points:
    ``deep_front`` (SuperPoint, LightGlue over the windowed and retrieval
    pairs, epipolar verification) -> ``run_sfm(match_tables=...)`` with
    DEEP_OPTIONS; launch counts set to 0 just before and read just after.
    ``first``: an earlier run's ``(front, scene, stats)`` on the same images,
    which this one must repeat bit for bit. ``dump``: a path to save the
    world's tables and result to (``dump_deep_world``) before any check.
    Returns (record, front, scene, stats); ``front`` is (xy, desc, mask,
    tables)."""
    import torch
    from eacham_tpu_torch.features.deep.frontend import PAIR_CHUNK
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg, trajectory_ate

    imgs = torch.as_tensor(images, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    xy, desc, mask, tables, t_extract, t_match = deep_front(models, imgs, intr, dev)
    scene, stats = run_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                           options=SfmOptions(**DEEP_OPTIONS), device=dev, match_tables=tables)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = launch_counts()
    require(stats["initialized"], f"world {world}: run_sfm found no init pair: {stats}")
    valid = scene.pose_valid.cpu().numpy()
    ate = trajectory_ate(scene.pose.cpu().numpy()[valid], poses[valid])  # bench_deep.py:117-124
    i0, j0 = stats["init_pair"]
    rot, trans = relative_pose_error_deg(stats["T_init"].cpu().numpy(), poses[i0], poses[j0])
    P = int(tables[0].shape[0])
    want = -(-P // PAIR_CHUNK) * 4 * models[1].n_layers
    front = (xy, desc, mask, tables)
    rec = {"world": world, "run": int(first is not None),
           "seconds": dict(extract=t_extract, match=t_match,
                           init_pair=stats["seconds"]["init_pair"],
                           seed=stats["seconds"].get("seed", 0.0),
                           sweep=stats["seconds"]["sweep"],
                           finalize=stats["seconds"]["finalize"], total=total),
           "registered": stats["registered"], "excluded": stats["excluded"],
           "landmarks": stats["landmarks"], "ate": ate,
           "init_pair": [i0, j0], "init_rot_deg": rot, "init_trans_deg": trans,
           "used_homography": stats["used_homography"], "n_good": stats["n_good"],
           "pairs": P, "edges": stats["edges"], "global_ba": stats["global_ba"],
           "map_refine_rounds": len(stats.get("map_refine") or []),
           "attention_launches": launches["masked_attention"], "attention_expected": want,
           "match_pairs_launches": launches["match_pairs"], "digest": scene_digest(scene)}
    if dump is not None:
        dump_deep_world(dump, front, poses, intr, rec)
    if first is not None:
        f_front, f_scene, f_stats = first
        front_equal = all(torch.equal(a, b) for a, b in zip(
            (*f_front[:3], *f_front[3]), (*front[:3], *front[3])))
        differ = same_reconstruction((f_scene, f_stats), (scene, stats))
        rec.update(front_equal=front_equal, repeat_equal=front_equal and not differ)
        require(front_equal, f"world {world}'s repeat: the features or match tables differ")
        require(not differ, f"world {world}'s repeat differs from its first run in {differ}")
    print(f"deep_sfm world {world}{' (repeat)' if first is not None else ''} on {card}: "
          f"registered {rec['registered']}/{N_FRAMES}, landmarks {rec['landmarks']}, ATE "
          f"{ate:.4f}, init pair ({i0}, {j0}) rot {rot:.4f} / t-dir {trans:.4f} deg, "
          f"attention launches {rec['attention_launches']} (expected {want}), "
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["seconds"].items()), flush=True)
    require(rec["attention_launches"] == want and rec["match_pairs_launches"] == 0,
            f"world {world}: launches {launches}, want {want} of masked_attention and no "
            "match_pairs")
    require(scene.pose.isfinite().all() and scene.points[scene.lm_valid].isfinite().all(),
            f"world {world}: non-finite poses or landmarks")
    ba = stats["global_ba"]
    require(ba is not None and ba["final_cost"] < ba["initial_cost"],
            f"world {world}: the global BA did not run or did not reduce its cost: {ba}")
    # no pair_window: the AUTO rule runs no map-refinement round, as the
    # reference's (eacham_tpu/sfm/pipeline.py:993-994)
    require(rec["map_refine_rounds"] == 0, f"world {world}: {rec['map_refine_rounds']} "
            "map-refinement rounds, not 0")
    return rec, front, scene, stats


def dump_deep_world(path, front, poses, intr, rec):
    """Save one deep world's 6-tuple, keypoints and ground truth for
    scripts/deep_sfm_replay_{jax,torch}.py (and the init-pair scripts)."""
    xy, _, mask, tables = front
    names = ("pair_idx", "pair_ok", "match_ij", "valid_ij", "match_ji", "valid_ji")
    np.savez_compressed(path, intr=intr, poses=poses, keypoints=xy.cpu().numpy(),
                        kp_mask=mask.cpu().numpy(), world=rec["world"],
                        port_registered=rec["registered"], port_ate=rec["ate"],
                        port_init_pair=np.asarray(rec["init_pair"]),
                        **{k: t.cpu().numpy() for k, t in zip(names, tables)})
    print(f"wrote deep world {rec['world']}'s match tables to {path}", flush=True)


def run_deep_sfm(models, images, intr, poses, dev, card, dumps=None):
    """The deep bench's five worlds to the end, world 0 twice (``deep_sfm``):
    one JSON line, the bench's gate, equal bits on the repeat, kernel 3
    against its plain version on world 0's first chunk. ``dumps``: {world:
    path} to save with ``dump_deep_world``."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    others, workers = render_deep_worlds()
    t_render = time.perf_counter() - t0
    print(f"rendered worlds 1-{DEEP_WORLDS - 1} ({N_FRAMES} frames {WIDTH}x{HEIGHT} each) in "
          f"{t_render:.2f} s with {workers} processes (untimed set-up)", flush=True)
    recs, first = [], None
    for world, imgs in enumerate([images, *others]):
        rec, front, scene, stats = run_deep_world(models, imgs, intr, poses, dev, card, world,
                                                  dump=(dumps or {}).get(world))
        recs.append(rec)
        if world == 0:
            first = (front, scene, stats)
        del front, scene, stats
    del others
    rec, _, _, _ = run_deep_world(models, images, intr, poses, dev, card, 0, first=first)
    errs, _ = attention_vs_plain(models[1], *first[0], "deep_sfm world 0")
    del first
    ates = [r["ate"] for r in recs]
    median_ate = float(np.median(ates))
    out = {"phase": "deep_sfm", "card": card, "frames": N_FRAMES, "max_keypoints": DEEP_KPS,
           "window": DEEP_WINDOW, "retrieval_k": DEEP_RETRIEVAL, "threshold": DEEP_THRESHOLD,
           "worlds": recs, "repeat": rec, "repeat_equal": rec["repeat_equal"],
           "median_ate": median_ate, "min_registered": min(r["registered"] for r in recs),
           "attention_max_abs_err": max(errs.values()), "render_seconds": t_render,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    for r in recs:
        require(r["registered"] >= DEEP_SFM_MIN_REGISTERED,
                f"deep bench gate: world {r['world']} registered {r['registered']} of {N_FRAMES}")
    require(median_ate < DEEP_SFM_MAX_MEDIAN_ATE, f"deep bench gate: median ATE {median_ate}")
    return out


# ---- the eleventh slice: the README's 1000-frame rows and stress_100 ---------

# scripts/anchor_probe.py's recipe (its options, :106-120, with the defaults
# filled in, are LOOP_OPTIONS and its two anchor sigmas): scripts/stress_500.py's
# world and orbit at 1000 frames, half the parallax a frame; then five frames
# spread evenly over the registered ones (:146-148) anchored to their ground
# truth, expressed in the reconstruction's frame, and the scene re-finalized
ANCHOR_FRAMES, ANCHOR_COUNT = 1000, 5
ANCHOR_OPTIONS = dict(LOOP_OPTIONS, abs_sigma_pos=0.05, abs_sigma_rot=0.005)
# the gate: the JAX package's runs registered 1000/1000 at ATE 2.02-2.04
# without anchors and 0.0326 with them (README.md, SCALING.md:908-933); the
# orbit's radius is 14
ANCHOR_MIN_REGISTERED, ANCHOR_MAX_ATE, ANCHORED_MAX_ATE = 950, 3.0, 0.1


def anchor_ids_of(valid, count: int = ANCHOR_COUNT) -> np.ndarray:
    """``count`` frames spread evenly over the registered ones
    (scripts/anchor_probe.py:146-148)."""
    reg = np.flatnonzero(np.asarray(valid))
    return reg[np.linspace(0, len(reg) - 1, count).round().astype(int)]


def rotation_deg(a, b) -> np.ndarray:
    """The angle (deg) of each rotation a[n] b[n]^T of two pose stacks, from
    its sine and cosine (exact near zero, where an arccos of the trace is
    not)."""
    d = np.einsum("nij,nkj->nik", np.asarray(a, np.float64)[:, :3, :3],
                  np.asarray(b, np.float64)[:, :3, :3])
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], 1)
    return np.degrees(np.arctan2(np.linalg.norm(w, axis=1) / 2,
                                 (np.trace(d, axis1=1, axis2=2) - 1) / 2))


def anchor_distances(pose, anchors, ids) -> dict:
    """Each anchored frame's camera-centre distance (scene units) and
    rotation angle (deg) from its anchor, with no alignment."""
    from eacham_tpu_torch.device import to_numpy

    T = to_numpy(pose)[ids].astype(np.float64)
    A = np.asarray(anchors)[ids].astype(np.float64)
    c = -np.einsum("nij,ni->nj", T[:, :3, :3], T[:, :3, 3])
    ca = -np.einsum("nij,ni->nj", A[:, :3, :3], A[:, :3, 3])
    return {"center": np.linalg.norm(c - ca, axis=1).tolist(),
            "rot_deg": rotation_deg(T, A).tolist()}


def run_anchors(dev, card, records, dump_loop=None):
    """scripts/anchor_probe.py's recipe uncut (``anchors``): the 1000 frames
    rendered by the process pool -> ``run_loop`` (``extract_features``
    in chunks of 500 -> ``run_sfm``: one ``match_pairs`` launch, the loop
    stage, three map-refinement rounds; its JSON line and checks, held to
    the 1000-frame gate) -> ``check_drift_repair`` on that scene -> five
    anchors from ``anchors_in_estimate_frame`` -> ``resume_sfm(abs_anchors=
    ...)``, with no matcher launch. One JSON line (both runs' stages, ATEs
    and BAs, each anchored frame's distance from its anchor, the anchored
    scene's ``digest``) and the reference's verdict line; then kernel 1
    against its plain version at this shape (``kernels[0].anchors``)."""
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm import anchors_in_estimate_frame
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, resume_sfm

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    images, poses, intr, workers = render_loop_workload(ANCHOR_FRAMES)
    t_render = time.perf_counter() - t0
    print(f"rendered {ANCHOR_FRAMES} frames {WIDTH}x{HEIGHT} of the stress orbit in "
          f"{t_render:.2f} s with {workers} processes (untimed set-up)", flush=True)
    scene, _, (_, desc, mask), run0 = run_loop(images, poses, intr, dev, card)
    del images
    check_drift_repair(scene, poses, dev, card, dump=dump_loop)

    valid = scene.pose_valid.cpu().numpy()
    ids = anchor_ids_of(valid)
    anchors, anchor_mask = anchors_in_estimate_frame(scene.pose, poses, ids, valid=valid)
    opt = SfmOptions(**ANCHOR_OPTIONS)
    print(f"anchoring frames {ids.tolist()} (sigma pos {opt.abs_sigma_pos}, rot "
          f"{opt.abs_sigma_rot} rad)", flush=True)
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    anchored, st = resume_sfm(scene, options=opt, verbose=True,
                              abs_anchors=(anchors, anchor_mask), device=dev)
    sync(dev)
    t_resume = time.perf_counter() - t0
    launches = launch_counts()["match_pairs"]
    ate0 = run0["ate"]["final"]
    ate1 = _ate(anchored.pose, anchored.pose_valid, poses)
    out = {"phase": "anchors", "card": card, "frames": ANCHOR_FRAMES, "anchors": ids.tolist(),
           "sigma_pos": opt.abs_sigma_pos, "sigma_rot": opt.abs_sigma_rot,
           "render_seconds": t_render, "run_sfm": run0,
           "resume": {"seconds": dict(st["seconds"], total=t_resume),
                      "registered": st["registered"], "excluded": st["excluded"],
                      "landmarks": st["landmarks"], "lm_allocated": int(anchored.n_landmarks),
                      "global_ba": st["global_ba"], "map_refine": st["map_refine"],
                      "match_pairs_launches": launches},
           "ate": {"unanchored": ate0, "anchored": ate1, "ratio": ate0 / ate1},
           "anchor_error": {"unanchored": anchor_distances(scene.pose, anchors, ids),
                            "anchored": anchor_distances(anchored.pose, anchors, ids)},
           "digest": scene_digest(anchored), "seconds": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    print(f"ATE with {ANCHOR_COUNT} absolute anchors: {ate1:.4f} (was {ate0:.4f})", flush=True)
    # the reference's verdict (scripts/anchor_probe.py:188-193)
    print("CONFIRMED: the residual error was the unobservable warp (removed by absolute "
          "references)" if ate1 < 0.35 * ate0 else
          "NOT confirmed: anchors did not collapse ATE -> solver deficiency to chase", flush=True)
    require(launches == 0, f"resume_sfm launched the matcher {launches} times")
    require(bool(anchored.pose.isfinite().all())
            and bool(anchored.points[anchored.lm_valid].isfinite().all()),
            "the anchored resume left non-finite poses or landmarks")
    require(st["registered"] >= ANCHOR_MIN_REGISTERED,
            f"anchors gate: {st['registered']} of {ANCHOR_FRAMES} frames registered anchored")
    require(ate1 < ANCHORED_MAX_ATE and ate1 < ate0,
            f"anchors gate: anchored ATE {ate1} (unanchored {ate0})")
    del anchored
    check_kernel_at("anchors", desc, mask, scene.pair_idx, records[0], card,
                    launches=run0["match_pairs_launches"], plain_reps=2, profile=False)
    return out


# scripts/stress_100.py: the reference's lego-class problem size (BASELINE.md:
# about 100 images), 100 frames x 1024 tracks at 640x480, f = 600, 0.3 px of
# noise, one unit descriptor a point shared by every frame and 10% of the
# (frame, point) slots given a random one; exhaustive pairs (P = 5120) and its
# options (:43-47: a local BA at every registration by default)
STRESS_FRAMES, STRESS_POINTS, STRESS_SIZE = 100, 1024, (640, 480)
STRESS_OPTIONS = dict(
    min_initial_inliers=150, min_matches=25, ransac_hyps_e=256, ransac_hyps_h=128,
    ransac_hyps_pnp=256, lm_capacity=16384, refine_max_iters=30, global_max_iters=50,
    match_chunk=32)
# the gate: the JAX package's run registered 100/100 at ATE 0.0016 (README.md)
STRESS_MIN_REGISTERED, STRESS_MAX_ATE = 95, 0.01


def stress_world(n_frames: int = STRESS_FRAMES, n_pts: int = STRESS_POINTS, seed: int = 0):
    """scripts/stress_100.py's generator, draw for draw (numpy only).
    Returns (keypoints [n, p, 2], descriptors [n, p, 256], mask [n, p],
    world->camera poses [n, 4, 4], intrinsics [4])."""
    rng = np.random.default_rng(seed)
    f = 600.0
    pts = rng.uniform(-2, 2, (n_pts, 3))
    pts[:, 2] += 6.0
    intr = np.array([f, f, 320., 240.], np.float32)
    poses = []
    for i in range(n_frames):
        a = 0.012 * i
        c, s = np.cos(a), np.sin(a)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        T[:3, 3] = [0.05 * (i - n_frames / 2), 0.01 * i, 0.02 * i]
        poses.append(T)
    poses = np.stack(poses).astype(np.float32)
    pc = np.einsum("nij,pj->npi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([f * pc[..., 0] / pc[..., 2] + 320,
                   f * pc[..., 1] / pc[..., 2] + 240], -1)
    uv = (uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
    mask = ((uv[..., 0] >= 0) & (uv[..., 0] < 640) &
            (uv[..., 1] >= 0) & (uv[..., 1] < 480) & (pc[..., 2] > 0.1))
    desc = rng.normal(size=(n_pts, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    desc = np.broadcast_to(desc, (n_frames, n_pts, 256)).copy()
    corrupt = rng.random((n_frames, n_pts)) < 0.10
    nz = rng.normal(size=(n_frames, n_pts, 256)).astype(np.float32)
    nz /= np.linalg.norm(nz, axis=-1, keepdims=True)
    desc[corrupt] = nz[corrupt]
    return uv, desc, mask, poses, intr


def run_stress(features, poses, intr, dev, verbose=False):
    """One ``run_sfm`` of the stress recipe on features already on the card,
    launch counts set to 0 just before and read just after. Returns (scene,
    stats, record)."""
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm

    n = features[0].shape[0]
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    scene, stats = run_sfm(*features, image_size=STRESS_SIZE, intr=intr,
                           options=SfmOptions(**STRESS_OPTIONS), verbose=verbose, device=dev)
    sync(dev)
    total = time.perf_counter() - t0
    launches = launch_counts()["match_pairs"]
    require(stats["initialized"], f"stress_100 found no init pair: {stats}")
    rec = {"seconds": dict(stats["seconds"], total=total), "frames_per_s": n / total,
           "registered": stats["registered"], "excluded": stats["excluded"],
           "landmarks": stats["landmarks"], "ate": _ate(scene.pose, scene.pose_valid, poses),
           "init_pair": list(stats["init_pair"]), "pairs": stats["pairs"],
           "edges": stats["edges"], "global_ba": stats["global_ba"],
           "match_pairs_launches": launches, "digest": scene_digest(scene)}
    return scene, stats, rec


def run_stress_100(dev, card, records):
    """scripts/stress_100.py's recipe uncut (``stress_100``): ``run_sfm``
    twice on the card, as the script does. One JSON line; gate: each run at
    least 95 of 100 registered and ATE < 0.01, one ``match_pairs`` launch
    a run, the second run equal to the first bit for bit; then kernel 1
    against its plain version at this shape (``kernels[0].stress_100``)."""
    import torch

    uv, desc, mask, poses, intr = stress_world()
    seen = mask.sum(1)
    print(f"stress_100: visible pts/frame: {seen.min()} - {seen.max()}", flush=True)
    features = tuple(torch.as_tensor(a, device=dev) for a in (uv, desc, mask))
    first = run_stress(features, poses, intr, dev, verbose=True)
    scene, stats, rec = run_stress(features, poses, intr, dev)
    differ = same_reconstruction(first[:2], (scene, stats))
    out = {"phase": "stress_100", "card": card, "frames": STRESS_FRAMES,
           "points": STRESS_POINTS, "first": first[2], **rec, "repeat_equal": not differ}
    print(json.dumps(out), flush=True)
    print(f"stress_100 on {card}: registered {rec['registered']}/{STRESS_FRAMES}, landmarks "
          f"{rec['landmarks']}, ATE {rec['ate']:.4f}; first {first[2]['seconds']['total']:.1f}s; "
          f"steady: {rec['seconds']['total']:.1f}s = {rec['frames_per_s']:.2f} frames/s",
          flush=True)
    for r in (first[2], rec):
        require(r["match_pairs_launches"] == 1,
                f"stress_100 launched the matcher {r['match_pairs_launches']} times, not once")
        require(r["registered"] >= STRESS_MIN_REGISTERED,
                f"stress_100 gate: {r['registered']} of {STRESS_FRAMES} frames registered")
        require(r["ate"] < STRESS_MAX_ATE, f"stress_100 gate: ATE {r['ate']}")
    require(bool(scene.pose.isfinite().all()) and bool(scene.points[scene.lm_valid].isfinite().all()),
            "stress_100 left non-finite poses or landmarks")
    require(not differ, f"stress_100's second run differs from its first in {differ}")
    check_kernel_at("stress_100", features[1], features[2], scene.pair_idx, records[0], card,
                    launches=rec["match_pairs_launches"], plain_reps=2, profile=False)
    return out


# ---- the twelfth slice: the nuisance matrix, the matcher's held-out curve, the examples ----

# scripts/robustness_matrix.py's recipe: three textured-surface worlds (seeds
# 0-2, 4000 blobs), 60 frames of its orbit at 512x384, K=512 (the deep column
# 1024 at threshold 0.15), the bench's options with a local BA every 3rd
# registration (:149-155), each nuisance drawn from default_rng(7 + world)
ROBUST_FRAMES, ROBUST_WORLDS = 60, 3
ROBUST_OPTIONS = dict(BENCH_OPTIONS, local_ba_every=3)
ROBUST_DEEP_KPS, ROBUST_DEEP_THRESHOLD = 1024, 0.15


def vignette(h, w, strength):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
    return 1.0 - strength * r2


NUISANCES = {
    "clean":        [("", {})],
    "noise":        [(f"sigma={s}", {"noise": s}) for s in (0.01, 0.03, 0.06)],
    "blur":         [(f"sigma={s}px", {"blur": s}) for s in (0.5, 1.0, 2.0)],
    "exposure":     [(f"{p}%+vignette", {"exposure": p / 100}) for p in (15, 30, 50)],
    "noise+blur":   [("0.03/1.0px", {"noise": 0.03, "blur": 1.0})],
    "drop-frames":  [(f"{p}%", {"drop": p / 100}) for p in (10, 20, 30)],
}


def apply_nuisance(images, rng, noise=0.0, blur=0.0, exposure=0.0, drop=0.0):
    """scripts/robustness_matrix.py's nuisances, draw for draw: blur, then
    exposure gain and gamma under a vignette, then sensor noise, then
    dropped frames (never the first or the last). Returns (images, the
    kept frames' indices or None)."""
    from eacham_tpu_torch.utils.synthetic import gaussian_blur

    out = images
    if blur > 0:
        out = np.stack([gaussian_blur(im, blur) for im in out])
    if exposure > 0:
        vig = vignette(out.shape[1], out.shape[2], 0.4 * exposure / 0.5)
        gains = np.exp(rng.uniform(-exposure, exposure, len(out)))
        gammas = np.exp(rng.uniform(-exposure, exposure, len(out)))
        out = np.stack([
            np.clip((np.clip(im * g * vig, 0, 1)) ** gm, 0, 1)
            for im, g, gm in zip(out, gains, gammas)])
    if noise > 0:
        out = np.clip(out + rng.normal(scale=noise, size=out.shape), 0, 1)
    keep = None
    if drop > 0:
        n = len(out)
        kill = rng.choice(np.arange(1, n - 1), int(drop * n), replace=False)
        keep = np.setdiff1d(np.arange(n), kill)
        out = out[keep]
    return out.astype(np.float32), keep


# the phase's cells: clean and the most severe level of the blur, noise+blur
# and drop-frames families (the script runs all 14). The most severe noise
# (sigma=0.06) and exposure (50%+vignette) cells were cut after the first
# whole run took 833 s against an 800 s mark, 22 s each (PERF.md, Findings)
ROBUST_CELLS = (("clean", ""), ("blur", "sigma=2.0px"), ("noise+blur", "0.03/1.0px"),
                ("drop-frames", "30%"))
# the gate, per cell: every world at least 95% registered (the reference:
# 100% on every world of every cell, robustness_matrix.json) and the median
# ATE under 0.1, except at 2 px of blur, where the reference itself reads
# 0.2265 (SCALING.md:640-643): 1.5x that
ROBUST_MIN_REGISTERED, ROBUST_MAX_ATE = 0.95, 0.1
ROBUST_MAX_ATE_OF = {("blur", "sigma=2.0px"): 1.5 * 0.2265}
# one RANSAC seed's cell median rides on the draws. On the card over seeds
# 0-15 (0-7 for clean; scripts/robustness_split_torch.py, PERF.md Findings)
# noise+blur reads 0.044-0.098 and clean 0.007-0.106, spreads that reach the
# limit: these two are gated on the median of seeds 0-2's cell medians, so
# that a change which only reorders the draws fails only if two of three
# seeds cross. Blur 2 px (0.077-0.157 against 0.34) and drop 30%
# (0.013-0.072) stay well inside it on one seed
ROBUST_SEEDS_OF = {("clean", ""): 3, ("noise+blur", "0.03/1.0px"): 3}


def robust_worlds(n_frames: int = ROBUST_FRAMES, n_worlds: int = ROBUST_WORLDS,
                  size=(WIDTH, HEIGHT)):
    """The script's surface worlds at ``size`` (width, height), rendered by
    a pool of processes over the host's cores (untimed set-up). Returns (a
    list of [n, H, W] image arrays, poses, intr, the number of
    processes)."""
    from eacham_tpu_torch.utils.synthetic import make_surface_scene, orbit_poses

    f = 1.2 * max(size)
    intr = np.array([f, f, size[0] / 2, size[1] / 2], np.float32)
    poses = orbit_poses(n_frames, radius=0.6, step_deg=0.8, advance=0.04)
    workers = render_workers()
    tasks, spans = [], []
    for w in range(n_worlds):
        blobs = make_surface_scene(np.random.default_rng(w), n_blobs=4000)
        chunks = [c for c in np.array_split(np.arange(n_frames), workers) if len(c)]
        spans.append((len(tasks), len(tasks) + len(chunks)))
        tasks += [(blobs, poses[c], intr, size) for c in chunks]
    parts = render_in_pool(tasks, workers)
    return [np.concatenate(parts[a:b]) for a, b in spans], poses, intr, workers


def robust_run(images, poses, intr, dev, frontend="classical", models=None,
               threshold=ROBUST_DEEP_THRESHOLD, seed=0):
    """One run of scripts/robustness_matrix.py's ``run_cell`` through the
    port's entry points, launch counts set to 0 just before and read just
    after: classical ``extract_features(K=512)``, or deep
    ``extract_deep_batch(K=1024)`` -> ``build_match_tables_deep`` over all
    pairs, epipolar-verified with seed 7 (``models``: the SuperPoint and
    LightGlue modules); then ``run_sfm`` with ROBUST_OPTIONS and RANSAC
    seed ``seed``. Returns
    (scene, stats, record, (xy, desc, mask)); below three registered frames
    the record's registered share is 0 and its ATE inf, as the script's."""
    import torch
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    n, h, w = images.shape
    opt = SfmOptions(**ROBUST_OPTIONS, seed=seed)
    imgs = torch.as_tensor(images, device=dev)
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    tables = None
    if frontend == "deep":
        from eacham_tpu_torch.features.deep.frontend import (
            build_match_tables_deep, extract_deep_batch)

        superpoint, matcher = models
        xy, desc, _, mask = extract_deep_batch(superpoint, imgs, max_keypoints=ROBUST_DEEP_KPS,
                                               device=dev)
        tables = build_match_tables_deep(
            matcher, xy, desc, mask, (w, h), min_matches=opt.min_matches, threshold=threshold,
            verify=(intr, torch.Generator(device=dev).manual_seed(DEEP_VERIFY_SEED),
                    opt.max_repr_error, opt.verify_hyps), device=dev)
    else:
        from eacham_tpu_torch.features.frontend import extract_features

        xy, desc, _, mask = extract_features(imgs, max_keypoints=MAX_KPS, device=dev)
    sync(dev)
    t_front = time.perf_counter() - t0
    scene, stats = run_sfm(xy, desc, mask, image_size=(w, h), intr=intr, options=opt,
                           device=dev, match_tables=tables)
    sync(dev)
    total = time.perf_counter() - t0
    launches = launch_counts()
    valid = scene.pose_valid.cpu().numpy()
    enough = valid.sum() >= 3
    ate = trajectory_ate(scene.pose.cpu().numpy()[valid], poses[valid]) if enough else float("inf")
    rec = {"frames": n, "registered": float(valid.sum() / n) if enough else 0.0, "ate": ate,
           "seconds": dict(front=t_front, **stats["seconds"], total=total),
           "pairs": stats["pairs"], "edges": stats["edges"], "landmarks": stats["landmarks"],
           "launches": launches, "digest": scene_digest(scene)}
    return scene, stats, rec, (xy, desc, mask)


def run_robustness(dev, card, records):
    """scripts/robustness_matrix.py's classical column at full width on
    ROBUST_CELLS (``robustness``): the three worlds rendered by the process
    pool, each cell's nuisance applied to each world, ``robust_run`` on each
    (one ``match_pairs`` launch a run), the clean cell's world 0 twice with
    equal digests, a cell of ROBUST_SEEDS_OF on several RANSAC seeds. One
    JSON line with every cell's registrations, ATEs and seconds; the gate per
    cell; then kernel 1 against its plain version on
    the clean cell's world 0 (``kernels[0].robustness``, with the P of every
    cell)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    worlds, poses, intr, workers = robust_worlds()
    t_render = time.perf_counter() - t0
    print(f"robustness: rendered {len(worlds)} surface worlds x {len(poses)} frames "
          f"{worlds[0].shape[2]}x{worlds[0].shape[1]} in {t_render:.2f} s with {workers} processes (untimed set-up)",
          flush=True)
    cells, failed, kernel_in, launches = [], [], None, 0
    for family, level in ROBUST_CELLS:
        t_cell = time.perf_counter()
        runs, seed_ates, inputs = [], [], []
        for w, images in enumerate(worlds):
            imgs, keep = apply_nuisance(images, np.random.default_rng(7 + w),
                                        **dict(NUISANCES[family])[level])
            inputs.append((imgs, poses[keep] if keep is not None else poses))
        for seed in range(ROBUST_SEEDS_OF.get((family, level), 1)):
            seed_runs = []
            for w, (imgs, gt) in enumerate(inputs):
                scene, _, rec, (_, desc, mask) = robust_run(imgs, gt, intr, dev, seed=seed)
                launches += rec["launches"]["match_pairs"]
                require(rec["launches"]["match_pairs"] == 1,
                        f"robustness {family} {level} world {w}: launches {rec['launches']}")
                require(bool(scene.pose.isfinite().all()),
                        f"robustness {family} {level} world {w}: non-finite poses")
                if family == "clean" and w == 0 and seed == 0:
                    again = robust_run(imgs, gt, intr, dev)[2]
                    launches += again["launches"]["match_pairs"]
                    rec["repeat_digest"] = again["digest"]
                    kernel_in = (desc, mask, scene.pair_idx)
                seed_runs.append(dict(rec, seed=seed))
                del scene, desc, mask
            seed_ates.append(float(np.median([r["ate"] for r in seed_runs])))
            runs += seed_runs
        reg = min(r["registered"] for r in runs)
        ate = float(np.median(seed_ates))
        limit = ROBUST_MAX_ATE_OF.get((family, level), ROBUST_MAX_ATE)
        cell = {"family": family, "level": level, "frames": runs[0]["frames"],
                "registered": reg, "ate": ate, "seed_ates": seed_ates, "ate_limit": limit,
                "pairs": runs[0]["pairs"], "worlds": runs,
                "seconds": time.perf_counter() - t_cell}
        cells.append(cell)
        over = (f" over seeds 0-{len(seed_ates) - 1} "
                f"({'/'.join(f'{a:.3f}' for a in seed_ates)})" if len(seed_ates) > 1 else "")
        print(f"[{family:12s} {level:14s}] frames={cell['frames']:3d} reg>={reg:5.1%} "
              f"ATE~{ate:8.4f} ({'/'.join(f'{r['ate']:.3f}' for r in runs)}){over} limit "
              f"{limit:.4f}, P={cell['pairs']} ({cell['seconds']:.1f}s)", flush=True)
        if reg < ROBUST_MIN_REGISTERED or not ate < limit:
            failed.append(f"{family} {level}: registered {reg}, ATE {ate} (limit {limit})")
    clean0 = cells[0]["worlds"][0]
    out = {"phase": "robustness", "card": card, "frames": ROBUST_FRAMES, "worlds": ROBUST_WORLDS,
           "max_keypoints": MAX_KPS, "cells": cells,
           "repeat_equal": clean0["digest"] == clean0["repeat_digest"],
           "match_pairs_launches": launches, "render_seconds": t_render,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(out), flush=True)
    require(not failed, f"robustness gate: {failed}")
    require(out["repeat_equal"], f"robustness: the clean cell's world 0 repeat differs "
            f"({clean0['digest'][:12]} / {clean0['repeat_digest'][:12]})")
    check_kernel_at("robustness", *kernel_in, records[0], card, launches=launches, plain_reps=3,
                    profile=False)
    records[0]["robustness"]["cell_P"] = {f"{c['family']} {c['level']}".strip(): c["pairs"]
                                          for c in cells}
    return out


# scripts/tune_deep_recall.py's held-out set: 48 SuperPoint-output pairs of
# blob worlds from make_sp_batch with default_rng(99), 64 keypoints (the top
# half kept), batches of 8; the script's thresholds, then the meta's
# operating points
RECALL_THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.25, 0.15, 0.1)
RECALL_PAIRS, RECALL_KPS, RECALL_SEED, RECALL_BATCH = 48, 64, 99, 8
# the JAX package's figures on the same pairs, on the CPU (precision, recall;
# JAX_PLATFORMS=cpu python scripts/deep_recall_jax.py, which runs
# scripts/tune_deep_recall.py's own sweep)
RECALL_JAX_CPU = {
    0.3: (0.7921760391198044, 0.7414187643020596),
    0.4: (0.841642228739003, 0.6552511415525114),
    0.5: (0.875, 0.5753424657534246),
    0.6: (0.9191489361702128, 0.4920273348519362),
    0.25: (0.7527352297592997, 0.7926267281105991),
    0.15: (0.704331450094162, 0.8617511520737328),
    0.1: (0.6742556917688266, 0.8891454965357968)}
# weights/lightglue.meta's figures (precision, recall), written when the
# shipped matcher was trained
RECALL_META = {0.5: (0.815, 0.516), 0.25: (0.725, 0.778), 0.15: (0.673, 0.865),
               0.1: (0.642, 0.904)}
RECALL_TOL = 0.02
# one batch's assignment scores (probabilities) with kernel 3 against the
# plain attention, through the 3 layers
RECALL_SCORE_TOL = 1e-4


def recall_counts(superpoint, matcher, thresholds, n_pairs=RECALL_PAIRS, max_kps=RECALL_KPS,
                  seed=RECALL_SEED):
    """scripts/tune_deep_recall.py's ``sweep`` counts: per threshold [tp,
    fp, fn] of ``match_deep`` against the labels of ``make_sp_batch`` over
    ``n_pairs`` held-out pairs in batches of 8 (one forward per batch and
    threshold), on the modules' device."""
    import torch
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep.train import make_sp_batch

    dev = next(matcher.parameters()).device
    rng = np.random.default_rng(seed)
    stats = {t: [0, 0, 0] for t in thresholds}
    for _ in range(n_pairs // RECALL_BATCH):
        kp0, d0, m0, kp1, d1, m1, gt = make_sp_batch(superpoint, rng, batch=RECALL_BATCH,
                                                     max_kps=max_kps)
        t = [torch.as_tensor(a, device=dev) for a in (kp0, d0, m0, kp1, d1, m1)]
        for thr in thresholds:
            idx, valid, _ = lg.match_deep(matcher, *t, threshold=thr)
            idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
            correct = (idx == gt) & (gt >= 0)
            stats[thr][0] += int((valid & correct).sum())
            stats[thr][1] += int((valid & ~correct).sum())
            stats[thr][2] += int((~valid & (gt >= 0)).sum())
    return stats


def precision_recall(counts) -> tuple[float, float]:
    tp, fp, fn = counts
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def time_attention(q, k, v, m, card, label):
    """Kernel 3 against its plain version on one block's inputs (three runs
    with equal bits), timed a call, on the card alone (calls queued behind a
    long product), beside the plain version, ``scaled_dot_product_attention``
    and the bound. Returns its record."""
    import torch.nn.functional as F
    from eacham_tpu_torch.ops import attention as at

    o = repeated(lambda: at.masked_attention_kernel(q, k, v, m), f"attention, {label}")
    err = float((o - at.masked_attention_plain(q, k, v, m)).abs().max())
    require(err < 1e-5 * max(1.0, float(v.abs().max())),
            f"attention kernel off by {err} at the {label} shape")
    B, H, Nq, D = q.shape
    ms = cuda_ms(lambda: at.masked_attention_kernel(q, k, v, m), reps=50)
    # a launch here is shorter than the wrapper's host work: the card's
    # own time comes from launches queued behind a long product
    dev_ms = queued_ms(lambda: at.masked_attention_kernel(q, k, v, m), reps=50)
    plain_ms = cuda_ms(lambda: at.masked_attention_plain(q, k, v, m), reps=20)
    # yardstick only, never called by the port
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None, :])  # noqa: E731
    library_ms = cuda_ms(library, reps=50)
    library_dev_ms = queued_ms(library, reps=50)
    flops = 4.0 * H * Nq * D * float(m.sum())
    nbytes = 4.0 * (q.numel() + k.numel() + v.numel() + q.numel()) + m.numel()
    t_fma, t_3x = flops / PEAK_FP32_FLOPS, 3.0 * flops / PEAK_TF32_FLOPS
    t_ops, t_bytes = min(t_fma, t_3x), nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = ("operations (3xTF32)" if t_3x < t_fma else "operations") \
        if t_ops >= t_bytes else "bytes"
    print(f"attention kernel at the {label} shape [B={B}, H={H}, N={Nq}, D={D}], "
          f"{int(m.sum())}/{m.numel()} keys live, on {card}: {ms:.4f} ms a call, "
          f"{dev_ms:.4f} ms on the card alone (50 calls queued), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms a call "
          f"and {library_dev_ms:.4f} on the card alone, bound "
          f"{bound_ms:.4f} ms ({bound_by}: 3 x {flops:.4g} FLOP, {nbytes:.4g} B), max abs "
          f"err {err:.3g}, {REPEATS} equal runs", flush=True)
    require(min(ms, dev_ms) >= bound_ms,
            f"attention kernel {ms} / {dev_ms} ms is under its bound {bound_ms} ms")
    return {"shape": [B, H, Nq, D], "live_keys": int(m.sum()), "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "library_device_ms": library_dev_ms}


def run_recall(dev, card, records):
    """The shipped matcher's held-out operating curve (``recall``):
    ``recall_counts`` on the card at RECALL_THRESHOLDS, launch counts set to
    0 just before and read just after (12 attention launches a forward).
    One JSON line with precision and recall at each threshold beside the
    JAX package's CPU figures and the meta's; gate: within RECALL_TOL of the
    JAX package's at every threshold. Then one batch's scores with kernel 3
    against the plain attention (three kernel runs with equal bits) and the
    kernel timed at this shape (``kernels[1].recall``)."""
    import torch
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params
    from eacham_tpu_torch.features.deep.train import make_sp_batch
    from eacham_tpu_torch.ops import attention as at
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts

    superpoint, matcher, n_layers = load_frontend_params(device=dev)
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    counts = recall_counts(superpoint, matcher, RECALL_THRESHOLDS)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    forwards = len(RECALL_THRESHOLDS) * (RECALL_PAIRS // RECALL_BATCH)
    rows, off = [], []
    for thr in RECALL_THRESHOLDS:
        p, r = precision_recall(counts[thr])
        jp, jr = RECALL_JAX_CPU[thr]
        rows.append({"threshold": thr, "precision": p, "recall": r, "tp_fp_fn": counts[thr],
                     "jax_cpu": [jp, jr], "meta": list(RECALL_META.get(thr, ())) or None,
                     "d_precision": p - jp, "d_recall": r - jr})
        print(f"recall thr={thr:.2f}: precision {p:.4f} recall {r:.4f} (JAX on the CPU "
              f"{jp:.4f} / {jr:.4f}; meta {RECALL_META.get(thr, 'none')})", flush=True)
        if abs(p - jp) > RECALL_TOL or abs(r - jr) > RECALL_TOL:
            off.append(thr)
    out = {"phase": "recall", "card": card, "pairs": RECALL_PAIRS, "max_keypoints": RECALL_KPS,
           "n_layers": n_layers, "rows": rows, "tolerance": RECALL_TOL, "seconds": secs,
           "forwards": forwards, "launches": launches}
    print(json.dumps(out), flush=True)
    require(launches["masked_attention"] == 4 * n_layers * forwards,
            f"recall: attention launches {launches}, want {4 * n_layers * forwards}")
    require(not off, f"recall: thresholds {off} off the JAX package's figures by more than "
            f"{RECALL_TOL}")

    # kernel 3 on the first held-out batch: the scores with the kernel (three
    # runs, equal bits) against the plain attention
    batch = make_sp_batch(superpoint, np.random.default_rng(RECALL_SEED), batch=RECALL_BATCH,
                          max_kps=RECALL_KPS)
    t = [torch.as_tensor(a, device=dev) for a in batch[:6]]
    idx_k, valid_k, scores_k = repeated(lambda: lg.match_deep(matcher, *t),
                                        "recall batch 0 scores")
    kernel_fwd = at.masked_attention
    at.masked_attention = at.masked_attention_plain
    try:
        idx_p, valid_p, scores_p = lg.match_deep(matcher, *t)
    finally:
        at.masked_attention = kernel_fwd
    err = float((scores_k - scores_p).abs().max())
    agree = float(((valid_k == valid_p) & (~valid_k | (idx_k == idx_p))).float().mean())
    print(f"recall batch 0 on {card}: scores with kernel 3 against the plain attention, max "
          f"abs err {err:.3g} (limit {RECALL_SCORE_TOL}), match decisions at t=0.5 agree on "
          f"{agree:.6f}, {REPEATS} kernel runs equal", flush=True)
    require(err < RECALL_SCORE_TOL, f"recall: kernel-forward scores off by {err}")

    seen = []
    inner = lg.attention

    def grab(q, k, v, m):
        seen.append((q, k, v, m))
        return inner(q, k, v, m)

    lg.attention = grab
    try:
        lg.match_deep(matcher, *t)
    finally:
        lg.attention = inner
    timing = time_attention(*seen[0], card, "recall")      # the first self block
    records[1]["recall"] = {"launches": launches["masked_attention"], "launches_per_forward":
                            4 * n_layers, "scores_max_abs_err": err, "decision_agreement": agree,
                            **timing}
    return out


# the examples phase: each example once on the card as a subprocess of this
# script, on two of the bench's frames, the 12-frame demo and the bench's 100
# frames as PNGs in windows of 8
EXAMPLES_TIMEOUT = 300
# the stream example's input: a camera sliding sideways past a smooth
# textured surface (the surface world with 2500 blobs and no jitter off
# the sphere, so that overlapping blobs keep their order), 40 frames at
# 512x384, 1024 keypoints (the matcher kernel takes at most 1152). The
# example keeps SfmOptions' defaults (the reference's configs/SfmConfig.json:
# 450 initial inliers at a 3 deg angle), which seed no pair on the bench's
# orbit; here they do
SLIDE_FRAMES, SLIDE_KPS = 40, 1024
EXAMPLES_MIN_STREAMED, EXAMPLES_MAX_DEMO_ATE = int(0.95 * SLIDE_FRAMES), 0.1


def slide_frames(n_frames: int = SLIDE_FRAMES, size=(WIDTH, HEIGHT)) -> np.ndarray:
    """The stream example's frames, rendered by the process pool."""
    from eacham_tpu_torch.utils.synthetic import make_surface_scene, orbit_poses

    f = 1.2 * max(size)
    intr = np.array([f, f, size[0] / 2, size[1] / 2], np.float32)
    poses = orbit_poses(n_frames, radius=0.0, step_deg=0.0, advance=0.5)
    blobs = make_surface_scene(np.random.default_rng(0), n_blobs=2500, jitter=0.0)
    workers = render_workers()
    chunks = [c for c in np.array_split(np.arange(n_frames), workers) if len(c)]
    return np.concatenate(render_in_pool([(blobs, poses[c], intr, size) for c in chunks],
                                         workers))


def run_examples(images, card):
    """``examples/{extract_match,reconstruct_synthetic,stream_reconstruct}
    _torch.py`` on the card (``examples``), the four runs started together as
    subprocesses: extract_match with either frontend (``--weights weights``)
    on frames 0 and 1, the demo, and the stream over ``slide_frames`` in
    windows of 8 at 1024 keypoints. Each must exit 0; the overlays must
    exist, the demo's ATE be under 0.1 and the stream's transform.json hold
    at least 95% of the frames. One JSON line; everything under OUT /
    "examples", removed when the phase passes."""
    import re
    import shutil

    import torch
    from PIL import Image

    out = OUT / "examples"
    shutil.rmtree(out, ignore_errors=True)
    for folder, frames in (("images", images[:2]), ("slide", slide_frames())):
        (out / folder).mkdir(parents=True)
        for i, img in enumerate(frames):
            Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)).save(
                out / folder / f"frame{i:03d}.png")
    a, b = (str(out / "images" / f"frame{i:03d}.png") for i in (0, 1))
    ex = ROOT / "examples"
    runs = {
        "extract_match_classical": [str(ex / "extract_match_torch.py"), a, b,
                                    str(out / "classical.png")],
        "extract_match_deep": [str(ex / "extract_match_torch.py"), a, b, str(out / "deep.png"),
                               "--frontend", "deep", "--weights", "weights"],
        "reconstruct_synthetic": [str(ex / "reconstruct_synthetic_torch.py"), str(out / "demo")],
        "stream_reconstruct": [str(ex / "stream_reconstruct_torch.py"), str(out / "slide"),
                               "--window", "8", "--max-keypoints", str(SLIDE_KPS),
                               "--checkpoint", str(out / "stream_state.npz"),
                               "--out", str(out / "transform.json")],
    }
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for name, argv in runs.items()}
    res, text = {}, {}
    try:
        for name, p in procs.items():
            text[name], _ = p.communicate(timeout=EXAMPLES_TIMEOUT)
            res[name] = {"rc": p.returncode, "seconds": time.perf_counter() - t0}
            print(f"example {name}: rc {p.returncode}\n{text[name].strip()}", flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name in ("extract_match_classical", "extract_match_deep"):
        m = re.search(r"^(?:classical|deep): (\d+) matches$", text[name], re.M)
        res[name]["matches"] = int(m.group(1)) if m else None
    m = re.search(r"^ATE RMSE: (\S+)", text["reconstruct_synthetic"], re.M)
    ate = float(m.group(1)) if m else None
    transform = out / "transform.json"
    streamed = len(json.loads(transform.read_text())["frames"]) if transform.exists() else 0
    rec = {"phase": "examples", "card": card, "runs": res, "demo_ate": ate,
           "streamed_frames": streamed, "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    require(all(r["rc"] == 0 for r in res.values()),
            f"examples: exit codes { {k: r['rc'] for k, r in res.items()} }")
    require((out / "classical.png").exists() and (out / "deep.png").exists(),
            "examples: an overlay is missing")
    require(ate is not None and ate < EXAMPLES_MAX_DEMO_ATE, f"examples: the demo's ATE {ate}")
    require((out / "demo" / "transform.json").exists(), "examples: the demo wrote no transform")
    require(streamed >= EXAMPLES_MIN_STREAMED, f"examples: the stream's transform.json holds "
            f"{streamed} frames")
    shutil.rmtree(out)
    return rec


def dump_scene(path, scene, poses, intr):
    """Save the seeded scene's match tables for scripts/init_pair_spread_*.py."""
    t = {k: getattr(scene, k).cpu().numpy() for k in (
        "keypoints", "kp_mask", "pair_idx", "pair_ok", "match_ij", "valid_ij")}
    np.savez_compressed(path, intr=intr, poses=poses, **t)
    print(f"wrote the slice's match tables to {path}", flush=True)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", metavar="NPZ",
                    help="also save the classical slice's match tables and ground truth here")
    ap.add_argument("--dump-deep", metavar="NPZ",
                    help="also save the deep path's world 0 (its 6-tuple, keypoints, ground "
                         "truth and the port's result) here")
    ap.add_argument("--dump-deep-world", metavar="W", type=int, action="append", default=[],
                    help="with --dump-deep only: also save world W (1-4) of the deep_sfm "
                         "phase to NPZ's name + _wW.npz (repeatable)")
    ap.add_argument("--dump-loop", metavar="NPZ",
                    help="also save the anchors phase's unanchored poses and loop "
                         "measurements here")
    args = ap.parse_args()
    if args.dump_deep_world and not args.dump_deep:
        ap.error("--dump-deep-world needs --dump-deep")
    if any(not 0 <= w < DEEP_WORLDS for w in args.dump_deep_world):
        ap.error(f"--dump-deep-world: the worlds are 0-{DEEP_WORLDS - 1}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "eacham_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the eacham_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from eacham_tpu_torch.ops import build

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    info = build.build()
    print(f"built kernels from {build.CSRC.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v['seconds']:.2f} s{' (cached)' if v['cached'] else ''}"
                      for k, v in info.items()), flush=True)
    for name, v in info.items():
        print(f"nvcc {name}:\n{v['log'].strip()}", flush=True)
    from eacham_tpu_torch.io import native_loader

    t0 = time.perf_counter()
    require(native_loader.get_lib() is not None, "the native image loader did not build")
    print(f"built the native image loader ({native_loader.lib_path().relative_to(ROOT)}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    images, poses, intr = render_workload()
    print(f"rendered {N_FRAMES} frames {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.2f} s (untimed set-up)", flush=True)

    xy, desc, mask, scene, stats, launches = run_slice(images, intr, dev, card)
    if args.dump:
        dump_scene(args.dump, scene, poses, intr)
    # the kernel phase runs before the slice's checks, so that its numbers
    # are printed whatever those checks find
    records = [check_match_kernel(desc, mask, launches, card)]
    check_slice(xy, desc, mask, scene, stats, launches, poses)
    del xy, scene

    first = run_full(images, intr, poses, dev, card, 0)
    scenes = [first[0], run_full(images, intr, poses, dev, card, 1, first=first)[0]]
    del first
    run_resume(scenes[1], poses, dev, card)
    run_cli(images, poses, dev, card)
    _, captured = run_stream(images, poses, intr, dev, card)
    # window 5's own inputs: the [100, 512, 256] capacity table with the
    # unarrived rows masked and that window's new pairs, not bucketed
    check_kernel_at("stream", *captured, records[0], card)
    del captured
    # rectified stereo on the bench's frames (the seventh slice). Its kernel
    # check's profiler session follows the stream's closely: in a process
    # that has run a profiler session and then minutes of unprofiled work
    # (the later phases), the profiler has dropped kernel records of later
    # sessions (17-19 of 20 calls, whichever check it was).
    R = _recipe()
    left_desc, left_mask, right_desc, right_mask, _, stereo_launches = run_stereo(
        R, images, poses, intr, dev, card)
    check_match_pair_padding(left_desc, right_desc, left_mask, right_mask)
    check_stereo_kernel(left_desc, left_mask, right_desc, right_mask, stereo_launches,
                        records[0], card)
    del left_desc, left_mask, right_desc, right_mask

    models, deep, deep_launches = run_deep(images, intr, dev, card)
    records.append(check_attention_kernel(models, deep, deep_launches, card))
    pair_launches = run_pair_path(deep[1], deep[2])
    records.append(check_match_pair_kernel(deep[1], deep[2], pair_launches, card))
    check_deep(models, deep, deep_launches, poses)
    check_e2e(models, images, dev, card)
    deep_layers = models[1].n_layers
    del deep
    # the tenth slice: the deep bench's five worlds to the end
    dumps = {}
    if args.dump_deep:
        dump = Path(args.dump_deep)
        dumps = {0: dump, **{w: dump.with_name(f"{dump.stem}_w{w}.npz")
                             for w in args.dump_deep_world if w != 0}}
    deep_sfm = run_deep_sfm(models, images, intr, poses, dev, card, dumps=dumps)
    # kernel 3 on the whole deep path: launches in each world's run
    records[1]["deep_sfm"] = {"launches": [w["attention_launches"] for w in deep_sfm["worlds"]],
                              "max_abs_err": deep_sfm["attention_max_abs_err"]}
    del models, deep_sfm
    run_cli(images[:DEEP_CLI_FRAMES], poses, dev, card, deep_layers=deep_layers)

    # the long-trajectory path (the sixth slice's checks) at scripts/anchor_probe.py's
    # 1000 frames, then its five absolute anchors (the eleventh slice)
    run_anchors(dev, card, records, dump_loop=args.dump_loop)

    # the rest of the seventh slice: the sharded paths on the first run_sfm
    # scene, the public frontend API (its trace is only required to hold
    # kernels), TUM RGB-D (no profiler session)
    run_parallel(desc, mask, scenes[0], dev, card)
    del desc, mask, scenes
    run_api(images, dev, card)
    # the twelfth slice: the port's examples, as a user runs them
    run_examples(images, card)
    del images
    # twice on the same TUM directory: one reconstruction per input
    rgbd_desc, rgbd_mask, rgbd_scene, rgbd_launches, rgbd_stats = run_rgbd(R, dev, card)
    run_rgbd(R, dev, card, first=(rgbd_scene, rgbd_stats))
    # (a launch of 6 ms: the warm mean is the card's time, as at the loop shape)
    check_kernel_at("rgbd", rgbd_desc, rgbd_mask, rgbd_scene.pair_idx, records[0], card,
                    launches=rgbd_launches, plain_reps=2, profile=False)
    del rgbd_desc, rgbd_mask, rgbd_scene
    # the eleventh slice: scripts/stress_100.py's 100 frames x 1024 tracks
    run_stress_100(dev, card, records)
    # the twelfth slice: scripts/robustness_matrix.py's classical column and
    # scripts/tune_deep_recall.py's held-out operating curve
    run_robustness(dev, card, records)
    run_recall(dev, card, records)

    # the eighth slice: training the deep frontend (kernel 3 in the forward pass)
    art = run_train(dev, card)
    check_train_kernel(art, records[1], card)
    del art

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
