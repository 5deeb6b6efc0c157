"""The yardstick of kernel work: the card's published peaks, the operations
and bytes that kernel 1 (the batched descriptor matcher,
``ops.match_kernel`` -> ``csrc/match_pairs.cu``) and kernel 3 (masked
attention, ``ops.attention`` -> ``csrc/masked_attention.cu``) need for
their inputs, and the model FLOP of the deep front half (SuperPoint and
the attentional matcher), which a whole step's share of the peak reads.

The work is counted from the shapes and the real candidate pairs or live
keys, whatever implements the matcher or the attention: ``bucket_pairs``
pads the pair list with (0, 0) rows, which the kernel computes all the
same, and those are not work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at the full 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

BF16_BYTES = 2
FP32_BYTES = 4
OUT_BYTES = 4            # each of the six [P, Kp] outputs holds 4-byte words
N_OUTPUTS = 6

# SuperPointNet (features/deep/superpoint.py): (level, in, out, kernel) of
# each convolution; level l runs at the input's size halved l times (floored,
# as its 2x2 max pools do), every convolution keeping its input's size
SUPERPOINT_CONVS = (
    (0, 1, 64, 3), (0, 64, 64, 3),
    (1, 64, 64, 3), (1, 64, 64, 3),
    (2, 64, 128, 3), (2, 128, 128, 3),
    (3, 128, 128, 3), (3, 128, 128, 3),
    (3, 128, 256, 3), (3, 256, 65, 1),        # detector head: 64 cells and the dustbin
    (3, 128, 256, 3), (3, 256, 256, 1),       # descriptor head
)
MATCHER_DIM = 256                             # features/deep/lightglue.py's DIM


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


def masked_attention_work(batch: int, heads: int, nq: int, nk_live: float, head_dim: int,
                          nk: int | None = None) -> tuple[float, float]:
    """(FLOP, bytes) of masked attention over ``batch`` rows of ``heads``
    heads: ``nq`` queries against ``nk_live`` live keys a row (a mean over
    the rows where they differ; ``nk``, the key length, defaults to it).
    q k^T and p v over the live keys are 2 * nq * nk_live * head_dim
    multiply-adds a head, two FLOP each: 4 * B * H * Nq * Nk_live * D. The
    fp32 q, k, v and output are read or written once each, and the [B, Nk]
    one-byte mask once."""
    nk = nk_live if nk is None else nk
    flops = 4.0 * batch * heads * nq * nk_live * head_dim
    nbytes = FP32_BYTES * batch * heads * head_dim * (2 * nq + 2 * nk) + batch * nk
    return flops, nbytes


def superpoint_flops(frames: int, h: int, w: int) -> float:
    """Model FLOP of ``SuperPointNet`` on ``frames`` images of h x w pixels
    (as the network is handed them, padded): two a multiply-add of every
    convolution (``SUPERPOINT_CONVS``); the activations, pools, softmax and
    normalisation are left out. About 1.7e5 FLOP a pixel."""
    macs = 0
    for level, cin, cout, k in SUPERPOINT_CONVS:
        macs += (h >> level) * (w >> level) * cin * cout * k * k
    return 2.0 * frames * macs


def attention_matcher_flops(pairs: int, k: int, layers: int) -> float:
    """Model FLOP of ``LightGlueMatcher`` on ``pairs`` pairs of ``k``
    keypoints a side: two a multiply-add of its linear layers (the input
    projection; per layer four attention blocks, each q, k, v, the output
    projection and a 2d -> 2d -> d MLP; the final projections and the
    matchability heads), of each block's q k^T and p v over all k keys, and
    of the two [k, k] similarity products of the assignment; layer norms,
    rotary angles, activations and softmaxes are left out. About 30 GFLOP a
    pair at k 1024 and 3 layers."""
    d = MATCHER_DIM
    per_side = (d * d                                            # in_proj
                + layers * 2 * (4 * d * d + 2 * d * 2 * d + 2 * d * d)  # two blocks' linears
                + d * d + d)                                     # final, match
    per_pair = 2 * k * per_side + layers * 4 * 2 * k * k * d + 2 * k * k * d
    return 2.0 * pairs * per_pair


def bound_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds, the
    operations at ``peak_flops`` (kernel 1's bf16 by default)."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)
