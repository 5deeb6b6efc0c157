#!/usr/bin/env python3
"""The JAX package's StreamingReconstructor on chip_smoke.py's stream, on
the CPU: the reference figure for the port's streaming phase.

    JAX_PLATFORMS=cpu python scripts/stream_reference_jax.py [--seed 0]

The bench's 100 rendered frames (chip_smoke.render_workload: 512x384, seed
0) arrive in windows of 10 through ``StreamingReconstructor(max_frames=100,
K=512, window=6, retrieval_k=2, finalize_every=5)`` with the bench's
options; after window 5 the state is checkpointed and restored into a new
object, and the stream ends with ``finalize()``. Prints one line per
window (registered, wall seconds on this host) and a last JSON line with
the registered count and the ATE (camera centres after similarity
alignment, as bench.py measures it). Imports the JAX package; the frames
come from the port's numpy renderer, which is the reference's copy.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="SfmOptions.seed")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from eacham_tpu.sfm import SfmOptions
    from eacham_tpu.sfm.streaming import StreamingReconstructor
    from eacham_tpu.utils.evaluate import ate_rmse

    images, poses, intr = cs.render_workload()
    opts = dataclasses.replace(SfmOptions(**cs.BENCH_OPTIONS), max_features=cs.MAX_KPS,
                               seed=args.seed)
    size = (cs.WIDTH, cs.HEIGHT)
    rec = StreamingReconstructor(image_size=size, intr=intr, options=opts,
                                 max_frames=cs.N_FRAMES, **cs.STREAM)
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for w, s in enumerate(range(0, cs.N_FRAMES, cs.STREAM_CHUNK), start=1):
            t = time.perf_counter()
            st = rec.process(images[s:s + cs.STREAM_CHUNK])
            print(f"window {w}: arrived {st['arrived']}, registered {st['registered']}, "
                  f"{time.perf_counter() - t:.2f} s", flush=True)
            if w == cs.STREAM_CHECKPOINT_AFTER:
                path = os.path.join(tmp, "stream.npz")
                rec.checkpoint(path)
                rec = StreamingReconstructor.restore(
                    path, size, options=opts, window=cs.STREAM["window"],
                    retrieval_k=cs.STREAM["retrieval_k"],
                    finalize_every=cs.STREAM["finalize_every"])
        st = rec.finalize()
    valid = np.asarray(rec.scene.pose_valid)
    est = np.asarray(rec.scene.pose)[valid].astype(np.float64)
    gt = poses[valid].astype(np.float64)
    c_est = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("nij,ni->nj", gt[:, :3, :3], gt[:, :3, 3])
    print(json.dumps({"package": "eacham_tpu (JAX, CPU)", "seed": args.seed,
                      "registered": int(valid.sum()), "frames": cs.N_FRAMES,
                      "ate": float(ate_rmse(c_est, c_gt)),
                      "landmarks": int(np.asarray(rec.scene.lm_valid).sum()),
                      "seconds": time.perf_counter() - t_all}), flush=True)


if __name__ == "__main__":
    main()
