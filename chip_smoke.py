#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eacham_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--dump tables.npz] [--dump-deep tables_deep.npz]

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
   on the deep path (see DEEP_MAX_ROT_DEG).

``--dump`` / ``--dump-deep`` also save a path's match tables and
ground-truth poses, the input of ``scripts/init_pair_spread_{jax,torch}.py``.

Prints one JSON line of per-kernel numbers, then the contract line
``{"ok": true, "device": {...}}`` last. Any failure exits non-zero; without
a card, or without the port beside this script, it exits non-zero at once.
"""

from __future__ import annotations

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
    return stats


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
        run_full(images, intr, poses, dev, card, run)

    models, deep, deep_launches = run_deep(images, intr, dev, card)
    if args.dump_deep:
        dump_scene(args.dump_deep, deep[4], poses, intr)
    records.append(check_attention_kernel(models, deep, deep_launches, card))
    pair_launches = run_pair_path(deep[1], deep[2])
    records.append(check_match_pair_kernel(deep[1], deep[2], pair_launches, card))
    check_deep(models, deep, deep_launches, poses)

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
