"""The yardstick of kernel work: the card's published peaks, and the
operations and bytes that kernel 1 (the batched descriptor matcher,
``ops.match_kernel`` -> ``csrc/match_pairs.cu``) needs for its inputs.

The work is counted from the shapes and the real candidate pairs, whatever
implements the matcher: ``bucket_pairs`` pads the pair list with (0, 0)
rows, which the kernel computes all the same, and those are not work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at the full 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

BF16_BYTES = 2
OUT_BYTES = 4            # each of the six [P, Kp] outputs holds 4-byte words
N_OUTPUTS = 6


def match_pairs_work(pairs: int, kp: int, dim: int, frames: int) -> tuple[float, float]:
    """(FLOP, bytes) of matching ``pairs`` frame pairs with ``kp`` descriptor
    rows of ``dim`` values a frame: one multiply-add per element of each
    pair's [kp, kp] similarity, the rows of the ``frames`` touched read once
    (bf16 values and a one-byte mask), the pair list read and the six
    outputs written once."""
    flops = 2.0 * pairs * kp * kp * dim
    nbytes = (frames * kp * (dim * BF16_BYTES + 1) + pairs * 2 * 4
              + N_OUTPUTS * pairs * kp * OUT_BYTES)
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
