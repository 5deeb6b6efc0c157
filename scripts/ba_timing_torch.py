#!/usr/bin/env python3
"""Time the port's bundle adjustment alone on the card, at the shapes the
SfM paths give it, with the kernels that take its device time.

    python scripts/ba_timing_torch.py [--iters 10] [--reps 3] [--top 8]

Three synthetic problems made from a seed with numpy, in the layouts that
``sfm/scene.ba_problem_windowed`` builds:
  - ``local``: a local-BA window, 16 cameras x 1024 keypoint slots, not
    compacted, 8192 landmark slots, dense solver (the ``loop`` phase's
    sweep; the bench's at 512 slots);
  - ``global_dense``: 100 cameras, 49152 compacted observations, 3072
    landmark slots, dense solver (the bench's global BA);
  - ``global_pcg``: 500 cameras, 337920 compacted observations, 49152
    landmark slots, PCG (the ``loop`` phase's global BA, in rounds of 10
    iterations).
Each runs ``refine_ba`` for ``--iters`` LM iterations (tolerance 0) once to
warm up, then ``--reps`` times under synchronized host timers, then once
under ``torch.profiler``: prints the card, the milliseconds of a call and
of an LM iteration, the kernels and copies a call launches, and the
kernels with the most device time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {
    "local": dict(C=16, K=1024, L=8192, compact=None, solver="dense", live=0.45),
    "global_dense": dict(C=100, K=512, L=3072, compact=49152, solver="dense", live=0.9),
    "global_pcg": dict(C=500, K=1024, L=49152, compact=337920, solver="pcg", live=0.65),
}


def make_problem(C, K, L, compact, live, seed=0):
    """Cameras on a line looking down +z at landmarks in front of them;
    each camera's K slots hold a ``live`` share of observations of random
    landmarks (1 px noise), the rest masked with landmark 0, as the
    window builder leaves them; ``compact``: the live slots gathered in
    camera order into that many rows, the padded tail on camera 0."""
    import torch

    from eacham_tpu_torch.ba.core import BAProblem

    rng = np.random.default_rng(seed)
    O = C * K
    cam = np.repeat(np.arange(C), K)
    mask = rng.uniform(size=O) < live
    pt = np.where(mask, rng.integers(0, L, size=O), 0)
    pts = rng.uniform(-1.0, 1.0, size=(L, 3))
    pts[:, 2] += 6.0
    poses = np.tile(np.eye(4), (C, 1, 1))
    poses[:, 0, 3] = np.linspace(-1.0, 1.0, C)
    f = 600.0
    pc = pts[pt] + poses[cam, :3, 3]
    uv = np.stack([f * pc[:, 0] / pc[:, 2] + 320, f * pc[:, 1] / pc[:, 2] + 240], -1)
    uv += rng.normal(scale=1.0, size=uv.shape)
    if compact:
        keep = np.flatnonzero(mask)[:compact]
        pad = compact - keep.size

        def take(a, fill):
            return np.concatenate([a[keep], np.full((pad,) + a.shape[1:], fill, a.dtype)])

        cam, pt, uv, mask = take(cam, 0), take(pt, 0), take(uv, 0.0), take(mask, False)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    dev = torch.device("cuda")

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    return BAProblem(
        poses=t(poses, torch.float32),
        points=t(pts + rng.normal(scale=0.01, size=pts.shape), torch.float32),
        intr=t([f, f, 320.0, 240.0], torch.float32), obs_cam=t(cam, torch.int64),
        obs_pt=t(pt, torch.int64), obs_uv=t(uv, torch.float32), obs_mask=t(mask, torch.bool),
        cam_in_ba=torch.ones(C, dtype=torch.bool, device=dev), cam_fixed=t(fixed, torch.bool),
        pt_in_ba=torch.ones(L, dtype=torch.bool, device=dev),
        pt_obs_count=torch.full((L,), 3.0, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ba_timing: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    from eacham_tpu_torch.ba.core import BAConfig, refine_ba

    card = card_line()
    print(card, flush=True)
    for name in args.shapes.split(","):
        shape = dict(SHAPES[name])
        solver = shape.pop("solver")
        p = make_problem(**shape)
        cfg = BAConfig(max_iters=args.iters, tolerance=0.0, solver=solver)

        def call():
            out = refine_ba(p, cfg)
            torch.cuda.synchronize()
            return out

        call()
        secs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = call()
            secs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        busy = sum(t for t, _ in by_name.values()) / 1e3
        ms = sorted(1e3 * s for s in secs)
        print(f"{name} ({solver}, {p.poses.shape[0]} cameras, {p.obs_cam.shape[0]} observations, "
              f"{p.points.shape[0]} landmarks) on {card}: {out[3]['iterations']} iterations, "
              f"ms a call {', '.join(f'{m:.2f}' for m in ms)} (median {ms[len(ms) // 2]:.2f}, "
              f"{ms[len(ms) // 2] / out[3]['iterations']:.2f} an iteration); "
              f"{len(kernels)} kernels and copies a call, device time {busy:.2f} ms, "
              f"final cost {float(out[3]['final_cost']):.6f}", flush=True)
        for kname, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(f"  {t / 1e3:9.3f} ms {n:6d}  {kname[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
