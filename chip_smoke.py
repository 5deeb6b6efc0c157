#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eacham_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--dump tables.npz] [--dump-deep tables_deep.npz]
                          [--dump-loop loop.npz]

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
     registered frames, landmarks, ATE, init pair, global BA) and must pass
     the bench's gate: at least 95 of 100 frames registered, ATE < 0.1;
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
   ``"phase"`` key, its stage seconds and the card, and each held to the
   bench's gate (at least 95 of 100 frames, ATE < 0.1) unless it says
   otherwise:
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
7. drives the long-trajectory path at scripts/stress_500.py's recipe
   (``loop``): 500 frames of the surface world on the stress orbit, rendered
   by a pool of processes, ``extract_features(K=1024)`` -> ``run_sfm`` with
   the recipe's options (windowed match graph over about 8192 pairs, sweep,
   the loop-closing stage, global BA and three map-refinement rounds); one
   JSON line with each stage's seconds, the ATE after the sweep, after the
   loop stage and at the end, and the stage statistics; gate: at least 475
   of 500 frames registered, ATE < 1.0, one ``match_pairs`` launch, the loop
   stage entered, three refinement rounds. Then both loop solvers on the
   card's own measurements of the finished scene under a smooth drift ramp
   (the loop consistency must fall to half or less), and the batched
   matcher at this shape against its plain version (``kernels[0].loop``).

The phases write what they make under ``chiprun_out/`` (images, configs,
outputs, checkpoints). ``--dump`` / ``--dump-deep`` also save a path's match tables and
ground-truth poses, the input of ``scripts/init_pair_spread_{jax,torch}.py``;
``--dump-loop`` the loop phase's poses and loop measurements, the input of
``scripts/loop_replay_{jax,torch}.py``.

Prints one JSON line of per-kernel numbers, then the contract line
``{"ok": true, "device": {...}}`` last. Any failure exits non-zero; without
a card, or without the port beside this script, it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
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


def kernel_launches(fn) -> int:
    """Kernels that one ``fn()`` runs on the card, counted under
    ``torch.profiler`` (copies and memsets are not kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
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
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
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


def run_full(images, intr, poses, dev, card, run):
    """images -> features -> finished reconstruction through
    ``extract_features`` and ``run_sfm`` at the bench's size and options,
    timed per stage; prints the run's JSON line and holds it to the
    bench's gate."""
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
    print(json.dumps({
        "phase": "run_sfm", "run": run, "card": card,
        "seconds": dict(extract=t_extract, **stats["seconds"], total=total),
        "frames_per_s": N_FRAMES / total,
        "registered": stats["registered"], "excluded": stats["excluded"],
        "landmarks": stats["landmarks"], "ate": ate,
        "init_pair": list(stats["init_pair"]), "used_homography": stats["used_homography"],
        "n_good": stats["n_good"], "edges": stats["edges"], "global_ba": ba,
        "match_pairs_launches": launches["match_pairs"]}), flush=True)
    init_pose_line(f"run_sfm run {run}", stats, poses)
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


def deep_stages(models, imgs, intr, dev):
    """The deep path once, through the port's entry points, timed per
    stage: images -> SuperPoint features -> LightGlue match tables over
    windowed candidate pairs, epipolar-verified -> seeded two-view map.
    Returns (xy, desc, mask, tables, scene, stats, seconds)."""
    import torch
    from eacham_tpu_torch.features.deep.frontend import (
        build_match_tables_deep, extract_deep_batch)
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, initialize_sfm

    superpoint, matcher = models
    opt = SfmOptions(**DEEP_OPTIONS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xy, desc, _, mask = extract_deep_batch(superpoint, imgs, max_keypoints=DEEP_KPS, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables = build_match_tables_deep(
        matcher, xy, desc, mask, (WIDTH, HEIGHT), min_matches=opt.min_matches,
        pair_window=DEEP_WINDOW, retrieval_k=DEEP_RETRIEVAL, threshold=DEEP_THRESHOLD,
        verify=(intr, torch.Generator(device=dev).manual_seed(DEEP_VERIFY_SEED),
                opt.max_repr_error, opt.verify_hyps), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    scene, stats = initialize_sfm(xy, desc, mask, image_size=(WIDTH, HEIGHT), intr=intr,
                                  options=opt, device=dev, match_tables=tables)
    torch.cuda.synchronize()
    secs = dict(extract_deep=t1 - t0, match_deep=t2 - t1,
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


def check_attention_kernel(models, out, launches, card):
    """Kernel vs plain version on one chunk's q, k, v and mask as the main
    path makes them (first self and first cross block), plus the ragged
    and the fully masked cases; returns the kernel's JSON record."""
    import torch
    import torch.nn.functional as F
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep.frontend import PAIR_CHUNK
    from eacham_tpu_torch.ops import attention as at

    xy, desc, mask, tables = out[:4]
    dev = desc.device
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
        lg.match_deep(models[1], kps[pi[:, 0]], desc[pi[:, 0]], mask[pi[:, 0]],
                      kps[pi[:, 1]], desc[pi[:, 1]], mask[pi[:, 1]], threshold=DEEP_THRESHOLD)
    finally:
        lg.attention = inner
    require(len(seen) == 4 * models[1].n_layers, f"{len(seen)} attention calls in one chunk")
    cases = {"self": seen[0], "cross": seen[2]}
    errs = {}
    for name, (q, k, v, m) in cases.items():
        require(tuple(q.shape) == (PAIR_CHUNK, 4, DEEP_KPS, 64), q.shape)
        o = repeated(lambda: at.masked_attention_kernel(q, k, v, m), f"attention, {name} block")
        ref = at.masked_attention_plain(q, k, v, m)
        scale = max(1.0, float(v.abs().max()))
        errs[name] = float((o - ref).abs().max())
        print(f"attention kernel vs plain, main-path {name} block {tuple(q.shape)}, "
              f"{REPEATS} equal runs: "
              f"max abs err {errs[name]:.3g} (limit 1e-5 x max(1, |v|max = {scale:.3g})), "
              f"live keys {int(m.sum())}/{m.numel()}", flush=True)
        require(errs[name] < 1e-5 * scale, f"attention kernel off by {errs[name]} ({name})")

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
    rec = {"phase": "cli_deep" if deep else "cli", "card": card, "frames": n,
           "max_data_count": cfg["max_data_count"], "exit_code": rc, "decoder": decoder,
           "seconds": {**stages, "total": total}, "registered": len(frames), "ate": ate,
           "cloud_points": n_cloud, "trajectory_points": n_traj,
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
           "global_ba": st2["global_ba"]}
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
           "global_ba": st["global_ba"]}
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
    alone = "" if dev_ms is None else f", {dev_ms:.4f} ms on the card alone (profiler)"
    print(f"match kernel at the {tag} shape on {card}: {ms:.4f} ms a call warm (mean of "
          f"20, the wrapper's host work included){alone}, cold_ms {cold:.4f}, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP, "
          f"{nbytes:.4g} B)", flush=True)
    require(ms >= bound_ms, f"match kernel {ms} ms is under its bound {bound_ms} ms")
    record[tag] = {"P": P, "Kp": Kp, "frames": frames, "table_rows": desc_bf.shape[0],
                   "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "cold_ms": cold,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    if launches is not None:
        record[tag]["launches"] = launches


# ---- the sixth slice: the long-trajectory path -----------------------------------

# scripts/stress_500.py's recipe: 500 frames of the surface world on the
# radius-14 stress orbit (one turn and 4% more, so the tail revisits the
# start), K=1024, and its options (stress_500.py:116-131)
LOOP_FRAMES, LOOP_KPS, LOOP_EXTRACT_CHUNK = 500, 1024, 500
LOOP_OPTIONS = dict(
    pair_window=10, pair_retrieval_k=3, max_observers=12,
    min_initial_inliers=80, min_matches=20, match_ratio=0.85,
    init_min_tri_angle_deg=0.8, min_tri_angle_deg=0.8,
    ransac_hyps_e=256, ransac_hyps_h=128, ransac_hyps_pnp=256,
    lm_capacity=131072, refine_max_iters=30, global_max_iters=100,
    match_chunk=32, interim_ba_iters=10, loop_close=True, local_ba_every=1,
    local_ba_free_span=6, map_refine_rounds=-1, sweep_segment=128, ba_program_iters=10)
# the gate: the JAX package's run of this recipe registered 500/500 at ATE
# 0.416 (README.md), its earlier runs of related recipes spread 0.82-1.41
# (SCALING.md); the orbit's radius is 14
LOOP_MIN_REGISTERED, LOOP_MAX_ATE = 475, 1.0
# the drift that the repair check puts on the finished trajectory: a smooth
# ramp (tests/test_submap.py's form) of up to 0.4 rad and 0.2 of the
# trajectory's radius (the reconstruction's scale is its own)
LOOP_DRIFT_ROT, LOOP_DRIFT_TRANS = 0.4, 0.2


def _render_frames(args):
    """A process pool's task: render the views ``poses`` of the scene."""
    blobs, poses, intr = args
    from eacham_tpu_torch.utils.synthetic import render_view

    return np.stack([render_view(blobs, T, intr, WIDTH, HEIGHT) for T in poses])


def render_loop_workload():
    """The stress recipe's 500 frames, rendered by a pool of processes
    over the host's cores (untimed set-up)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from eacham_tpu_torch.utils.synthetic import make_surface_scene, stress_orbit_poses

    f = 1.2 * max(WIDTH, HEIGHT)
    intr = np.array([f, f, WIDTH / 2, HEIGHT / 2], np.float32)
    blobs = make_surface_scene(np.random.default_rng(0), n_blobs=4000, jitter=0.05)
    poses = stress_orbit_poses(LOOP_FRAMES)
    workers = max(1, min(os.cpu_count() or 1, 16))
    tasks = [(blobs, poses[c], intr)
             for c in np.array_split(np.arange(LOOP_FRAMES), 4 * workers) if len(c)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        images = np.concatenate(list(ex.map(_render_frames, tasks)))
    return images, poses, intr, workers


def _ate(pose, valid, gt):
    from eacham_tpu_torch.utils.evaluate import trajectory_ate

    v = valid.cpu().numpy()
    return trajectory_ate(pose.cpu().numpy()[v], gt[v]) if v.sum() >= 3 else float("inf")


def run_loop(images, poses, intr, dev, card):
    """The long-trajectory path once: ``extract_features(K=1024)`` ->
    ``run_sfm`` with the stress recipe's options (windowed match graph with
    one ``match_pairs`` launch -> init pair -> sweep with interim BA ->
    loop-closing stage -> global BA and the three map-refinement rounds),
    launch counts set to 0 just before and read just after. The poses
    after the sweep and after the loop stage are read by wrapping the two
    stage functions. Returns (scene, stats, features, record)."""
    import torch
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.ops import launch_counts, reset_launch_counts
    from eacham_tpu_torch.sfm import pipeline as pl

    snaps = {}
    close_loops, finalize = pl._close_loops, pl._finalize

    def at_loop(scene, *a, **k):
        snaps["sweep"] = (scene.pose.clone(), scene.pose_valid.clone())
        return close_loops(scene, *a, **k)

    def at_finalize(scene, *a, **k):
        snaps["loop"] = (scene.pose.clone(), scene.pose_valid.clone())
        return finalize(scene, *a, **k)

    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    parts = []
    for lo in range(0, LOOP_FRAMES, LOOP_EXTRACT_CHUNK):
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
                                  options=pl.SfmOptions(**LOOP_OPTIONS), verbose=True,
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
    rec = {"phase": "loop", "card": card, "frames": LOOP_FRAMES, "max_keypoints": LOOP_KPS,
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
           "landmarks": stats["landmarks"], "ate": ate, "loop": loop, "map_refine": rounds,
           "global_ba": stats["global_ba"], "match_pairs_launches": launches["match_pairs"]}
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
    require(stats["registered"] >= LOOP_MIN_REGISTERED,
            f"loop gate: {stats['registered']} of {LOOP_FRAMES} frames registered")
    require(ate["final"] < LOOP_MAX_ATE, f"loop gate: ATE {ate['final']}")
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
                    help="also save the deep path's match tables and ground truth here")
    ap.add_argument("--dump-loop", metavar="NPZ",
                    help="also save the loop phase's poses and loop measurements here")
    args = ap.parse_args()
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
    del xy, desc, mask, scene

    for run in range(2):
        scene, _ = run_full(images, intr, poses, dev, card, run)
    run_resume(scene, poses, dev, card)
    del scene
    run_cli(images, poses, dev, card)
    _, captured = run_stream(images, poses, intr, dev, card)
    # window 5's own inputs: the [100, 512, 256] capacity table with the
    # unarrived rows masked and that window's new pairs, not bucketed
    check_kernel_at("stream", *captured, records[0], card)
    del captured

    models, deep, deep_launches = run_deep(images, intr, dev, card)
    if args.dump_deep:
        dump_scene(args.dump_deep, deep[4], poses, intr)
    records.append(check_attention_kernel(models, deep, deep_launches, card))
    pair_launches = run_pair_path(deep[1], deep[2])
    records.append(check_match_pair_kernel(deep[1], deep[2], pair_launches, card))
    check_deep(models, deep, deep_launches, poses)
    deep_layers = models[1].n_layers
    del models, deep
    run_cli(images[:DEEP_CLI_FRAMES], poses, dev, card, deep_layers=deep_layers)
    del images

    t0 = time.perf_counter()
    loop_images, loop_poses, loop_intr, workers = render_loop_workload()
    print(f"rendered {LOOP_FRAMES} frames {WIDTH}x{HEIGHT} of the stress orbit in "
          f"{time.perf_counter() - t0:.2f} s with {workers} processes (untimed set-up)",
          flush=True)
    scene, _, (_, loop_desc, loop_mask), loop_rec = run_loop(
        loop_images, loop_poses, loop_intr, dev, card)
    del loop_images
    check_drift_repair(scene, loop_poses, dev, card, dump=args.dump_loop)
    check_kernel_at("loop", loop_desc, loop_mask, scene.pair_idx, records[0], card,
                    launches=loop_rec["match_pairs_launches"], plain_reps=2, profile=False)
    del scene, loop_desc, loop_mask

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
