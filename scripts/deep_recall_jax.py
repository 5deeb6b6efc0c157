#!/usr/bin/env python3
"""The JAX package's held-out precision and recall of the shipped matcher,
on the CPU: the reference figures for the port's ``recall`` phase.

    JAX_PLATFORMS=cpu python scripts/deep_recall_jax.py [--n-pairs 48]

Loads the shipped weights as ``scripts/tune_deep_recall.py`` does
(SuperPoint, and LightGlue at the meta's layer count, both fp32) and runs
that script's own ``sweep`` (loaded by path: 48 held-out SuperPoint-output
pairs from ``make_sp_batch`` with ``default_rng(99)``, 64 keypoints) at
the script's four thresholds and at the meta's operating points 0.25,
0.15 and 0.1. Prints one line per threshold and a last JSON line
``{threshold: [precision, recall]}`` with the counts behind them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.25, 0.15, 0.1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-pairs", type=int, default=48)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from eacham_tpu.features.deep import lightglue as lg
    from eacham_tpu.features.deep import superpoint as sp

    spec = importlib.util.spec_from_file_location(
        "tune_deep_recall", ROOT / "scripts" / "tune_deep_recall.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    key = jax.random.PRNGKey(0)
    to32 = lambda t: jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), t)  # noqa: E731
    wdir = ROOT / "weights"
    sp_params = to32(lg.load_params(wdir / "superpoint.npz", sp.init_params(key)))
    n_layers = int([line for line in (wdir / "lightglue.meta").read_text().splitlines()
                    if line.startswith("n_layers")][0].split("=")[1])
    lg_params = to32(lg.load_params(wdir / "lightglue.npz",
                                    lg.init_params(key, n_layers=n_layers)))
    t0 = time.perf_counter()
    res = ref.sweep(sp_params, lg_params, n_layers, list(THRESHOLDS), n_pairs=args.n_pairs)
    for t, (p, r) in res.items():
        print(f"thr={t:.2f} precision={p:.4f} recall={r:.4f}", flush=True)
    print(json.dumps({"package": "eacham_tpu", "platform": "cpu", "n_pairs": args.n_pairs,
                      "n_layers": n_layers, "seconds": time.perf_counter() - t0,
                      "pr": {str(t): list(v) for t, v in res.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
