#!/usr/bin/env python3
"""The JAX package's loop solvers on loop measurements saved by
``chip_smoke.py --dump-loop``.

    JAX_PLATFORMS=cpu python scripts/loop_replay_jax.py loop.npz [--out jax_out.npz]

From the finished scene's poses and from the drifted ones the dump holds,
runs ``optimize_pose_graph`` (with the dump's edge and loop measurements)
and ``submap_align``, and prints each result's loop consistency and ATE
against ground truth. ``--out`` saves the results for
``scripts/loop_replay_torch.py --compare``. Imports only the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--out")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from eacham_tpu.sfm.posegraph import loop_consistency, optimize_pose_graph
    from eacham_tpu.sfm.submap import submap_align
    from eacham_tpu.utils.evaluate import align_umeyama

    d = np.load(args.dump)
    valid, fixed, gt = d["pose_valid"], d["pose_fixed"], d["gt"]
    lm = (d["pair_idx"], d["rows"], d["T_loop"], d["w_loop"])

    def ate(T):
        c = lambda P: -np.einsum("nij,ni->nj", P[valid, :3, :3], P[valid, :3, 3])
        s, R, t = align_umeyama(c(T).astype(np.float64), c(gt).astype(np.float64))
        return float(np.sqrt(np.mean(np.sum((s * c(T) @ R.T + t - c(gt)) ** 2, -1))))

    out, rec = {}, {}
    for start in ("pose", "drifted"):
        P = d[start]
        pg = np.asarray(optimize_pose_graph(
            jnp.asarray(P), jnp.asarray(valid), jnp.asarray(fixed), jnp.asarray(d["pair_idx"]),
            jnp.asarray(d["T_meas"]), jnp.asarray(d["w_meas"]), iters=int(d["pgo_iters"]),
            loop_rows=jnp.asarray(d["rows"]), T_loop=jnp.asarray(d["T_loop"]),
            w_loop=jnp.asarray(d["w_loop"])))
        sub = submap_align(P, valid, fixed, *lm[:2], d["T_loop"], d["w_loop"],
                           size=int(d["submap_size"]))
        out[f"{start}_pose_graph"], out[f"{start}_submap"] = pg, sub
        rec[start] = {"consistency_deg": {"input": loop_consistency(P, *lm),
                                          "pose_graph": loop_consistency(pg, *lm),
                                          "submap": loop_consistency(sub, *lm)},
                      "ate": {"input": ate(P), "pose_graph": ate(pg), "submap": ate(sub)}}
    print(json.dumps({"package": "eacham_tpu", "from": rec}))
    if args.out:
        np.savez(args.out, **out)


if __name__ == "__main__":
    main()
