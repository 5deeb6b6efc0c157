"""Kernel 1's work counted from shapes and real pairs (sfmbench/roofline.py)."""

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
