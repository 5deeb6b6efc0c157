#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eacham_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--dump tables.npz]

1. prints the card's name and power limit;
2. builds every CUDA kernel of the port from ``eacham_tpu_torch/csrc``;
3. renders the 100-frame bench workload (512x384, seed 0) with the port's
   own ``utils/synthetic.py`` and drives the slice's main path at full
   size: ``extract_features(K=512)`` -> ``initialize_sfm`` with the bench's
   options. Kernel launch counts are set to 0 just before and read just
   after;
4. holds each kernel against its plain PyTorch version on the inputs the
   main path gave it (N=100, K=512, P=5120 with bucket padding), plus the
   all-masked case, and times kernel, plain version and bound;
5. checks the slice: every kernel launched, edges survive, and the init
   pair's relative pose is within 1 deg rotation and 5 deg translation
   direction of ground truth (20 deg where the homography path was taken,
   see MAX_TRANS_DEG_H).

``--dump`` also saves the slice's match tables and ground-truth poses, the
input of ``scripts/init_pair_spread_{jax,torch}.py``.

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

# H100 SXM dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
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


def check_slice(xy, desc, mask, scene, stats, launches, poses):
    from eacham_tpu_torch.utils.evaluate import relative_pose_error_deg

    require(xy.shape == (N_FRAMES, MAX_KPS, 2) and desc.shape == (N_FRAMES, MAX_KPS, 256),
            (xy.shape, desc.shape))
    require(bool(xy.isfinite().all()) and bool(desc.isfinite().all()), "non-finite features")
    n_kps = mask.sum(1)
    require(int(n_kps.min()) > 0, "a frame has no keypoints")
    require(all(n >= 1 for n in launches.values()), f"a kernel never launched: {launches}")
    require(stats["pairs"] == 5120 and stats["edges"] > 0, stats)
    require(stats["initialized"] and stats["n_good"] > 100, stats)
    i0, j0 = stats["init_pair"]
    T = stats["T_init"].cpu().numpy()
    require(np.isfinite(T).all(), "non-finite init pose")
    rot, trans = relative_pose_error_deg(T, poses[i0], poses[j0])
    max_trans = MAX_TRANS_DEG_H if stats["used_homography"] else MAX_TRANS_DEG
    print(f"slice: keypoints/frame {int(n_kps.min())}-{int(n_kps.max())}, "
          f"edges {stats['edges']}/{stats['pairs']}, init pair ({i0}, {j0}), "
          f"n_good {stats['n_good']}, homography {stats['used_homography']}, "
          f"pose error rot {rot:.4f} deg (limit {MAX_ROT_DEG}), "
          f"t-dir {trans:.4f} deg (limit {max_trans})", flush=True)
    require(rot < MAX_ROT_DEG and trans < max_trans, f"init pose error {rot}, {trans} deg")
    pts = scene.points[scene.lm_valid]
    require(pts.shape[0] == stats["n_good"] and bool(pts.isfinite().all()),
            "seeded landmarks do not match n_good or are not finite")


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
    raw_k = mk.match_pairs_kernel(desc_bf, m, pairs)
    torch.cuda.synchronize()
    raw_p = mk.match_pairs_plain(desc_bf, m, pairs)
    names = ("row best", "row argmax", "row second", "col best", "col argmax", "col second")
    equal = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, raw_k, raw_p)}
    max_err = max(float((raw_k[i] - raw_p[i]).abs().max()) for i in (0, 2, 3, 5))
    _, vk = mk.decide(raw_k, m, pairs, BENCH_OPTIONS["match_ratio"])
    _, vp = mk.decide(raw_p, m, pairs, BENCH_OPTIONS["match_ratio"])
    agree = float((vk == vp).float().mean())
    both = vk & vp
    same_j = bool(torch.equal(raw_k[1][both], raw_p[1][both]))
    print(f"match kernel vs plain (N={desc.shape[0]}, Kp={Kp}, P={P}): raw equal {equal}, "
          f"max |best/second diff| {max_err:.3g}, decision agreement {agree:.6f}, "
          f"valid matches {int(vk.sum())} kernel / {int(vp.sum())} plain", flush=True)
    require(all(equal.values()) or (agree >= 0.999 and same_j),
            f"kernel disagrees with its plain version: {equal}, {agree}, {same_j}")

    # all keypoints masked: every output dead, no match
    dead = torch.zeros_like(m)
    raw_d = mk.match_pairs_kernel(desc_bf, dead, pairs[:64].contiguous())
    torch.cuda.synchronize()
    _, vd = mk.decide(raw_d, dead, pairs[:64], 0.8)
    require(not bool(vd.any()) and bool((raw_d[0] == mk.NEG).all())
            and bool((raw_d[3] == mk.NEG).all()), "all-masked case produced matches")
    print("match kernel all-masked case: no matches, all outputs dead", flush=True)

    ms = cuda_ms(lambda: mk.match_pairs_kernel(desc_bf, m, pairs), reps=10)
    plain_ms = cuda_ms(lambda: mk.match_pairs_plain(desc_bf, m, pairs), reps=2)
    flops = 2.0 * P * Kp * Kp * desc_bf.shape[2]
    nbytes = (desc_bf.numel() * 2 + m.numel() + pairs.numel() * 4
              + sum(o.numel() * o.element_size() for o in raw_k))
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    # partial yardstick, never called by the port: the same bf16 products
    # as one batched matmul, without the masking and top-2 reductions
    a = desc_bf[pairs[:, 0].long()]
    b = desc_bf[pairs[:, 1].long()].transpose(1, 2)
    bmm_ms = cuda_ms(lambda: torch.bmm(a, b), reps=10)
    del a, b
    print(f"match kernel on {card}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops:.4g} FLOP, {nbytes:.4g} B); partial yardstick torch.bmm of "
          f"the bf16 products alone {bmm_ms:.4f} ms", flush=True)
    return {"name": "match_pairs", "route": "cuda",
            "source": "eacham_tpu_torch/csrc/match_pairs.cu",
            "replaces": "eacham_tpu/ops/match_kernel.py:109",
            "launches": launches["match_pairs"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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
                    help="also save the slice's match tables and ground truth here")
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
    record = check_match_kernel(desc, mask, launches, card)
    check_slice(xy, desc, mask, scene, stats, launches, poses)

    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
