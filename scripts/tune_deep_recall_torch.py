#!/usr/bin/env python3
"""Deep-matcher recall on the PyTorch/CUDA port: threshold sweep and
fine-tuning (``scripts/tune_deep_recall.py`` on ``eacham_tpu_torch``), on
one NVIDIA card.

    python scripts/tune_deep_recall_torch.py [--steps 0] [--layers 0] [--batch 8]
        [--lr 1.5e-4] [--kps 64] [--save] [--device cpu]

Evaluates the precision and recall of the shipped LightGlue-class matcher
on held-out SuperPoint pairs (``sweep``: 48 pairs of blob worlds from
``make_sp_batch`` with ``default_rng(99)``, 64 keypoints, one
``match_deep`` forward per batch of 8 and threshold, the attention in
``csrc/masked_attention.cu``) at the thresholds 0.3-0.6, and prints the
reference's ``before:`` lines. ``--layers`` above the shipped count grafts
the trained layers into a deeper matcher (``graft``: copied by
``state_dict`` name, the new tail left at ``init_params`` from a
``torch.Generator`` seeded 1, so its draws are not the JAX package's).
``--steps`` fine-tunes with ``train_lightglue_sp`` and prints ``after:``
lines; with ``--save`` the matcher and a new ``lightglue.meta`` are
written into ``WEIGHTS`` in the JAX package's layout, only if the F1 at
threshold 0.5 rose. The held-out set and the counts are ``chip_smoke.py``'s,
whose ``recall`` phase sweeps the shipped weights with a gate.

Prints one JSON line with the sweeps and the card's name and power limit
last. Without a CUDA device and without ``--device cpu`` it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
WEIGHTS = ROOT / "weights"

from chip_smoke import precision_recall, recall_counts  # noqa: E402  (the held-out set's one copy)

THRESHOLDS = [0.3, 0.4, 0.5, 0.6]


def sweep(superpoint, matcher, thresholds, n_pairs=48, max_kps=64, seed=99):
    """{threshold: (precision, recall)} of ``matcher`` on ``n_pairs``
    held-out SuperPoint-output pairs (``tune_deep_recall.py:26-54``)."""
    counts = recall_counts(superpoint, matcher, thresholds, n_pairs, max_kps, seed)
    return {t: precision_recall(c) for t, c in counts.items()}


def graft(matcher, n_layers: int, n_kps: int = 64, generator=None):
    """A ``n_layers``-deep matcher holding ``matcher``'s trained tensors
    under their ``state_dict`` names, the layers past them at
    ``init_params`` (near-identity residual blocks), on ``matcher``'s
    device."""
    import torch
    from eacham_tpu_torch.features.deep import lightglue as lg

    deep = lg.init_params(generator or torch.Generator().manual_seed(1), n_layers=n_layers,
                          n_kps=n_kps)
    state = deep.state_dict()
    state.update({k: v for k, v in matcher.state_dict().items() if k in state})
    deep.load_state_dict(state)
    return deep.to(next(matcher.parameters()).device).eval().requires_grad_(False)


def f1(p: float, r: float) -> float:
    return 2 * p * r / max(p + r, 1e-9)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (0 = from meta; training with a larger count "
                         "grafts new random layers)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1.5e-4)
    ap.add_argument("--kps", type=int, default=64)
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("tune_deep_recall_torch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    from eacham_tpu_torch.features.deep import lightglue as lg
    from eacham_tpu_torch.features.deep import train
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (no card)"
    print(f"# {card}", flush=True)
    superpoint, matcher, n_layers = load_frontend_params(weights_dir=WEIGHTS, device=dev)
    if args.layers > n_layers:
        # graft: copy trained layers into a deeper stack, leave the new tail
        # at init (near-identity residual), fine-tune everything
        matcher = graft(matcher, args.layers, args.kps)
        n_layers = args.layers
        print(f"grafted to {n_layers} layers", flush=True)

    res0 = res = sweep(superpoint, matcher, THRESHOLDS)
    for t, (p, r) in res.items():
        print(f"before: thr={t:.2f} precision={p:.3f} recall={r:.3f}", flush=True)
    out = {"n_layers": n_layers, "before": {str(t): list(v) for t, v in res0.items()}}

    if args.steps > 0:
        t0 = time.perf_counter()
        matcher, losses = train.train_lightglue_sp(
            superpoint, steps=args.steps, batch=args.batch, lr=args.lr, n_layers=n_layers,
            params=matcher, n_kps=args.kps, device=dev)
        print(f"trained {args.steps} steps in {time.perf_counter() - t0:.0f}s, "
              f"final loss {np.mean(losses[-20:]):.4f}", flush=True)
        res = sweep(superpoint, matcher, THRESHOLDS)
        for t, (p, r) in res.items():
            print(f"after:  thr={t:.2f} precision={p:.3f} recall={r:.3f}", flush=True)
        out["after"] = {str(t): list(v) for t, v in res.items()}
        if args.save:
            (p5, r5), (p0, r0) = res[0.5], res0[0.5]
            f1_new, f1_old = f1(p5, r5), f1(p0, r0)
            out["saved"] = f1_new > f1_old
            if f1_new <= f1_old:
                print(f"NOT saved (F1 {f1_old:.3f} -> {f1_new:.3f})")
            else:
                lg.save_params(WEIGHTS / "lightglue.npz", matcher)
                (WEIGHTS / "lightglue.meta").write_text(
                    f"n_layers={n_layers}\nsteps=+{args.steps}\n"
                    f"finetune=scripts/tune_deep_recall_torch.py (on SuperPoint "
                    f"outputs)\nprecision={p5:.3f} (held-out SuperPoint-output "
                    f"pairs)\nrecall={r5:.3f}\n")
                print(f"saved {WEIGHTS / 'lightglue.npz'} + meta", flush=True)
    print(json.dumps({**out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
