#!/usr/bin/env python3
"""Reference-scale stress run on the PyTorch/CUDA port: 100 frames x 1024
keypoints (the lego-class workload of BASELINE.md) end to end, on one
NVIDIA card (``scripts/stress_100.py`` on ``eacham_tpu_torch``).

    python scripts/stress_100_torch.py [--device cpu]

The recipe is ``chip_smoke.py``'s, whose ``stress_100`` phase runs it with
its gate: ``stress_world`` (scripts/stress_100.py's generator, draw for
draw: 100 frames, 1024 points, f = 600 at 640x480, 0.3 px of noise, one
unit descriptor a point with 10% of the slots replaced by random ones) and
``STRESS_OPTIONS``. ``run_sfm`` runs twice, as in the reference script: the
first run builds the kernels, the second is the steady one. Prints the
reference script's lines and one JSON line with both runs' records (stage
seconds, registered, landmarks, ATE, ``match_pairs`` launches, ``digest``)
and the card's name and power limit. Without a CUDA device and without
``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import STRESS_FRAMES, stress_world  # noqa: E402  (the generator's one copy)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("stress_100_torch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, run_stress

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (no card)"
    print(f"# {card}", flush=True)
    uv, desc, mask, poses, intr = stress_world()
    print("visible pts/frame:", mask.sum(1).min(), "-", mask.sum(1).max(), flush=True)
    features = tuple(torch.as_tensor(a, device=dev) for a in (uv, desc, mask))
    _, _, first = run_stress(features, poses, intr, dev, verbose=True)
    _, stats, steady = run_stress(features, poses, intr, dev)
    t_first, t_steady = first["seconds"]["total"], steady["seconds"]["total"]
    print(f"registered {stats['registered']}/{STRESS_FRAMES}, landmarks {stats['landmarks']}, "
          f"ATE {steady['ate']:.4f}")
    print(f"first (with the kernels' build): {t_first:.1f}s; steady: {t_steady:.1f}s "
          f"= {STRESS_FRAMES / t_steady:.2f} frames/s")
    print(json.dumps({"first": first, "steady": steady,
                      "repeat_equal": first["digest"] == steady["digest"], "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
