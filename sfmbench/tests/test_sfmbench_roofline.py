"""Kernel 1's and kernel 3's work counted from shapes, real pairs and live keys,
and the deep front half's model FLOP (sfmbench/roofline.py)."""

from sfmbench import roofline


def test_bucketed_pairs_reproduce_the_kernel_table():
    # PERF.md's kernel table: N=100, Kp=512, P=5120 padded -> 6.872e11 FLOP,
    # 0.6948 ms at the bf16 peak
    flops, _ = roofline.match_pairs_work(5120, 512, 256, 100)
    assert f"{flops:.4g}" == "6.872e+11"
    assert abs(flops / roofline.PEAK_BF16_FLOPS * 1e3 - 0.6948) < 5e-5


def test_real_pairs_of_the_bench():
    flops, nbytes = roofline.match_pairs_work(4950, 512, 256, 100)
    assert f"{flops:.3g}" == "6.64e+11"
    # operations bound the bench's kernel: the bytes take a third of the time
    assert roofline.bound_seconds(flops, nbytes) == flops / roofline.PEAK_BF16_FLOPS
    assert nbytes / roofline.PEAK_BYTES_PER_S < flops / roofline.PEAK_BF16_FLOPS


def test_the_stress_100_shape():
    flops, _ = roofline.match_pairs_work(4950, 1024, 256, 100)
    assert flops == 2 * 4950 * 1024 ** 2 * 256      # 2.6575e12


# ---- kernel 3 and the deep front half ----------------------------------------------

def test_kernel_3_at_the_tables_shape():
    # PERF.md's kernel table: [32, 4, 1024, 64] fp32, all keys live -> 3.436e10 FLOP,
    # 1.343e8 B (q, k, v, output and the [32, 1024] one-byte mask)
    flops, nbytes = roofline.masked_attention_work(32, 4, 1024, 1024, 64)
    assert flops == 4 * 32 * 4 * 1024 * 1024 * 64
    assert f"{flops:.4g}" == "3.436e+10"
    assert nbytes == 4 * 4 * 32 * 4 * 1024 * 64 + 32 * 1024
    assert f"{nbytes:.4g}" == "1.343e+08"


def test_kernel_3_counts_live_keys_only_as_work():
    # the training mix: [8, 4, 256, 64], 1792 of 2048 keys live (224 a row):
    # 4.698e8 FLOP, 8.391e6 B (every key's k and v are read, live or not)
    flops, nbytes = roofline.masked_attention_work(8, 4, 256, 224, 64, nk=256)
    assert f"{flops:.4g}" == "4.698e+08" and f"{nbytes:.4g}" == "8.391e+06"
    full, full_bytes = roofline.masked_attention_work(8, 4, 256, 256, 64)
    assert flops == full * 224 / 256 and nbytes == full_bytes


def test_the_named_peaks():
    assert roofline.PEAK_FP32_FLOPS == 67e12 and roofline.PEAK_TF32_FLOPS == 494.7e12
    flops, nbytes = roofline.masked_attention_work(32, 4, 1024, 1024, 64)
    assert roofline.bound_seconds(flops, nbytes, roofline.PEAK_FP32_FLOPS) == flops / 67e12


def test_the_deep_front_half_by_hand():
    # SuperPoint: 84,804 multiply-adds a pixel at a size the pools divide evenly
    # (576 + 36,864 at full size; 73,728 / 4; 221,184 / 16; (294,912 + 672,000) / 64)
    assert roofline.superpoint_flops(1, 384, 512) == 2 * 84804 * 384 * 512
    assert 1.69e5 < roofline.superpoint_flops(100, 384, 512) / (100 * 384 * 512) < 1.71e5
    # the matcher at K 1024, 3 layers: 2 * K * 10 d^2 a block (12 blocks), 2 K^2 d a
    # block's products, 4 K d^2 + 2 K d outside the layers, 2 K^2 d of similarities
    k, d = 1024, 256
    macs = 12 * (10 * k * d * d + 2 * k * k * d) + 4 * k * d * d + 2 * k * d + 2 * k * k * d
    assert roofline.attention_matcher_flops(1536, k, 3) == 2.0 * 1536 * macs
    assert 30.5e9 < roofline.attention_matcher_flops(1, k, 3) < 30.7e9


def test_the_counts_equal_torchs_flop_counter():
    """The port's networks at a tiny size on the CPU (where ``attention`` runs
    as plain einsums) under ``FlopCounterMode``, which counts two FLOP a
    multiply-add of each convolution, matrix product and einsum: the counts
    are equal, since both count the same products and leave out the rest
    (biases, norms, activations, softmaxes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from eacham_tpu_torch.features.deep.lightglue import LightGlueMatcher
    from eacham_tpu_torch.features.deep.superpoint import SuperPointNet
    from eacham_tpu_torch.ops.attention import masked_attention_plain

    torch.manual_seed(0)
    with torch.no_grad():
        for (n, h, w) in ((2, 48, 64), (1, 44, 60)):      # the second: pools that floor
            with FlopCounterMode(display=False) as fc:
                SuperPointNet()(torch.rand(n, h, w))
            assert fc.get_total_flops() == roofline.superpoint_flops(n, h, w)
        k, layers, pairs = 24, 2, 3
        kps = torch.rand(pairs, k, 2) * 2 - 1
        desc = torch.nn.functional.normalize(torch.randn(pairs, k, 256), dim=-1)
        mask = torch.ones(pairs, k, dtype=torch.bool)
        with FlopCounterMode(display=False) as fc:
            LightGlueMatcher(n_layers=layers)(kps, desc, mask, kps, desc, mask)
        assert fc.get_total_flops() == roofline.attention_matcher_flops(pairs, k, layers)
        # kernel 3's work with every key live is the dense count of its plain version
        q, kk, v = (torch.randn(2, 4, 16, 64) for _ in range(3))
        with FlopCounterMode(display=False) as fc:
            masked_attention_plain(q, kk, v, torch.ones(2, 16, dtype=torch.bool))
        assert fc.get_total_flops() == roofline.masked_attention_work(2, 4, 16, 16, 64)[0]
