#!/usr/bin/env python3
"""Time the single-pair matcher kernel of the PyTorch/CUDA port on the card.

    python scripts/time_match_pair_torch.py [--k 1024] [--reps 200]

Prints the card's name and power limit, the nvcc resource line of the
kernel, and two times of ``ops.match_kernel.match_pair_kernel`` at K1 = K2 =
``--k`` on seeded unit descriptors: ``call_ms``, the mean over ``--reps``
calls enqueued back to back (what a caller pays: it includes the wrapper's
host work when that is slower than the card), and ``device_ms``, the same
calls enqueued behind a long-running product so that the card runs them
without waiting for the host (``chip_smoke.py``'s ``cuda_ms`` and
``queued_ms``), three times each.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    from chip_smoke import card_line, cuda_ms, queued_ms
    from eacham_tpu_torch.ops import build
    from eacham_tpu_torch.ops import match_kernel as mk

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_match_pair_torch: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    info = build.build(["match_pair"])
    print(info["match_pair"]["log"].strip(), flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    d = torch.nn.functional.normalize(
        torch.randn((2, args.k, 256), generator=g, device=dev), dim=-1)
    m = torch.rand((2, args.k), generator=g, device=dev) > 0.1
    d1, d2, m1, m2 = d[0].contiguous(), d[1].contiguous(), m[0].contiguous(), m[1].contiguous()

    def call():
        return mk.match_pair_kernel(d1, d2, m1, m2)

    raw = call()
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(raw, mk.match_pair_plain(d1, d2, m1, m2))]
    print(json.dumps({"card": card, "k": args.k, "raw_equal_plain": equal,
                      "call_ms": [cuda_ms(call, args.reps) for _ in range(3)],
                      "device_ms": [queued_ms(call, args.reps) for _ in range(3)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
