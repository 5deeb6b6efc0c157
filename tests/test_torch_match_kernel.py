"""The port's fused matchers (eacham_tpu_torch.ops.match_kernel), batched
and single-pair, against the JAX package's Pallas kernels run in interpret
mode, on the CPU.

On the CPU the port runs each kernel's plain PyTorch version; the CUDA
kernels themselves are compared with those plain versions by the tests
marked ``cuda``, which run only where a card is present. The JAX package is
imported inside the test that uses it, so that the ``cuda`` test also runs
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_match_kernel.py
"""

import numpy as np
import pytest
import torch

from eacham_tpu_torch.features.matching import match_all_pairs
from eacham_tpu_torch.ops import match_kernel as mk

torch.set_num_threads(2)


def _fixture(rng, N=7, K=96, D=256):
    """Correlated neighbours so real matches exist (tests/test_ops.py)."""
    desc = rng.normal(size=(N, K, D)).astype(np.float32)
    for i in range(1, N):
        desc[i, : K // 2] = (desc[i - 1, : K // 2]
                             + 0.02 * rng.normal(size=(K // 2, D)).astype(np.float32))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = rng.random((N, K)) > 0.1
    pairs = np.array([(i, j) for i in range(N) for j in range(i + 1, N)], np.int32)
    return desc, mask, pairs


@pytest.mark.parametrize("K", [96, 200])
def test_plain_matches_pallas_interpret(rng, K):
    """Decision agreement > 0.995 and equal match_j wherever both sides
    call a match valid (K=200 pads to two 128-row tiles, so the column
    merge across tiles is exercised)."""
    import jax.numpy as jnp
    from eacham_tpu.ops.match_kernel import match_pairs_fused as jax_match_pairs_fused

    desc, mask, pairs = _fixture(rng, K=K)
    mj_ref, mv_ref = jax_match_pairs_fused(jnp.asarray(desc), jnp.asarray(mask),
                                           jnp.asarray(pairs), interpret=True)
    mj, mv = mk.match_pairs_fused(torch.as_tensor(desc), torch.as_tensor(mask),
                                  torch.as_tensor(pairs))
    vr, vt = np.asarray(mv_ref), mv.numpy()
    assert mj.shape == (len(pairs), K) and mj.dtype == torch.int32
    assert (vr == vt).mean() > 0.995
    both = vr & vt
    np.testing.assert_array_equal(np.asarray(mj_ref)[both], mj.numpy()[both])
    assert both.sum() > 100


def _representable(seed, N=6, K=300, D=256):
    """Descriptors with entries in {-1, 0, 1} / 16: exact in bf16, and every
    product sum is exact in fp32 whatever its order, so the quantized
    similarities (and their many exact ties) are the same on every path."""
    r = np.random.default_rng(seed)
    desc = (r.integers(-1, 2, size=(N, K, D)) / 16.0).astype(np.float32)
    mask = r.random((N, K)) > 0.2
    pairs = np.array([(i, j) for i in range(N) for j in range(i + 1, N)]
                     + [(0, 0)] * 3, np.int32)
    return desc, mask, pairs


def test_plain_equals_pallas_interpret_on_exact_inputs():
    """With exact arithmetic on both sides the decisions, and match_j
    everywhere, are equal: the packing and tie rules agree bit for bit
    (K=300 pads to three 128-row tiles)."""
    import jax.numpy as jnp
    from eacham_tpu.ops.match_kernel import match_pairs_fused as jax_match_pairs_fused

    desc, mask, pairs = _representable(1)
    mj_ref, mv_ref = jax_match_pairs_fused(jnp.asarray(desc), jnp.asarray(mask),
                                           jnp.asarray(pairs), ratio=0.95, interpret=True)
    mj, mv = mk.match_pairs_fused(torch.as_tensor(desc), torch.as_tensor(mask),
                                  torch.as_tensor(pairs), ratio=0.95)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_ref))
    np.testing.assert_array_equal(mj.numpy(), np.asarray(mj_ref))
    assert mv.any()


def test_plain_all_masked(rng):
    """All-False keypoint masks yield zero matches, not a crash."""
    N, K, D = 3, 64, 256
    desc = rng.normal(size=(N, K, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mj, mv = mk.match_pairs_fused(torch.as_tensor(desc), torch.zeros(N, K, dtype=torch.bool),
                                  torch.tensor([[0, 1], [1, 2]], dtype=torch.int32))
    assert not mv.any()
    assert mj.shape == (2, K)


def test_plain_raw_outputs_follow_packing_rule():
    """Exact quantized ties go to the highest column (row pass) and, within
    a 128-row tile, to the highest row; across tiles the earlier tile keeps
    the column (``take_new = ctop > prev``). Dead entries unpack to NEG."""
    N, Kp, D = 2, 256, 256
    desc = torch.zeros(N, Kp, D)
    desc[:, :, 0] = 1.0
    mask = torch.ones(N, Kp, dtype=torch.uint8)
    mask[1, 5] = 0
    desc_bf, m = mk.prepare(desc, mask.bool())
    b1, a1, s1, b2, a2, s2 = mk.match_pairs_plain(desc_bf, m, torch.tensor([[0, 1]]))
    assert torch.all(b1 == 1.0) and torch.all(s1 == 1.0)
    assert torch.all(a1 == Kp - 1)
    assert a2[0, 0] == 127 and b2[0, 5] == mk.NEG and s2[0, 5] == mk.NEG
    live = torch.arange(Kp) != 5
    assert torch.all(a2[0, live] == 127)


def test_match_all_pairs_gate_and_padding_rows(rng):
    """The pair gate counts survivors and rejects (0, 0) bucket rows."""
    desc, mask, pairs = _fixture(rng)
    pairs = np.concatenate([pairs, np.zeros((3, 2), np.int32)])
    mj, mv, ok = match_all_pairs(torch.as_tensor(desc), torch.as_tensor(mask),
                                 torch.as_tensor(pairs), min_matches=10)
    counts = mv.sum(-1)
    np.testing.assert_array_equal(ok.numpy(), ((counts > 10)
                                               & torch.as_tensor(pairs[:, 0] < pairs[:, 1])).numpy())
    assert not ok[-3:].any() and ok[:6].all()


def test_wrapper_refuses_non_cuda_tensors(rng):
    """The kernel wrapper never runs the plain version on its own."""
    desc, mask, pairs = _fixture(rng, N=2, K=128)
    desc_bf, m = mk.prepare(torch.as_tensor(desc), torch.as_tensor(mask))
    with pytest.raises(ValueError):
        mk.match_pairs_kernel(desc_bf, m, torch.tensor([[0, 1]], dtype=torch.int32))
    assert mk.match_pairs_kernel.launches == 0


def _good_pairs_args():
    r = np.random.default_rng(0)
    desc = torch.as_tensor(r.normal(size=(3, 128, 256)).astype(np.float32))
    desc_bf, m = mk.prepare(desc, torch.ones(3, 128, dtype=torch.bool))
    return desc_bf, m, torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)


def _misaligned(t):
    """The same values, contiguous, one element off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# what the batched kernel's wrapper must refuse before it launches anything;
# the checks do not depend on the device, so they are held here on CPU tensors
BAD_PAIRS_ARGS = {
    "desc_fp32": lambda d, m, p: (d.float(), m, p),
    "desc_2d": lambda d, m, p: (d[0], m, p),
    "desc_width_128": lambda d, m, p: (d[..., :128].contiguous(), m, p),
    "desc_not_contiguous": lambda d, m, p: (d.transpose(0, 1).contiguous().transpose(0, 1), m, p),
    "desc_misaligned_for_the_tensor_map": lambda d, m, p: (_misaligned(d), m, p),
    "kp_not_a_tile_multiple": lambda d, m, p: (d[:, :96].contiguous(), m[:, :96].contiguous(), p),
    "mask_bool": lambda d, m, p: (d, m.bool(), p),
    "mask_wrong_shape": lambda d, m, p: (d, m[:2].contiguous(), p),
    "mask_not_contiguous": lambda d, m, p: (d, m.t().contiguous().t(), p),
    "mask_other_device": lambda d, m, p: (d, m.to("meta"), p),
    "pairs_int64": lambda d, m, p: (d, m, p.long()),
    "pairs_1d": lambda d, m, p: (d, m, p[0]),
    "pairs_three_columns": lambda d, m, p: (d, m, torch.zeros(2, 3, dtype=torch.int32)),
    "pairs_not_contiguous": lambda d, m, p: (d, m, p.t().contiguous().t()),
    "pairs_other_device": lambda d, m, p: (d, m, p.to("meta")),
    "pair_index_too_large": lambda d, m, p: (d, m, torch.tensor([[0, 3]], dtype=torch.int32)),
    "pair_index_negative": lambda d, m, p: (d, m, torch.tensor([[-1, 1]], dtype=torch.int32)),
}


@pytest.mark.parametrize("case", sorted(BAD_PAIRS_ARGS))
def test_pairs_kernel_argument_checks_refuse(case):
    good = _good_pairs_args()
    assert mk.check_pairs_kernel_args(*good) == (3, 128, 2)
    bad = BAD_PAIRS_ARGS[case](*good)
    if case == "desc_not_contiguous":
        assert not bad[0].is_contiguous()
    with pytest.raises(ValueError):
        mk.check_pairs_kernel_args(*bad)


def _check_cuda_pairs_kernel(desc, mask, pairs, ratio=0.8):
    """Kernel vs plain version: all raw outputs equal, or decisions agree on
    > 0.999 and match_j is equal wherever both call a match valid (fp32
    summation order may move a similarity by one quantization step)."""
    dev = torch.device("cuda")
    desc_bf, m = mk.prepare(torch.as_tensor(desc, device=dev), torch.as_tensor(mask, device=dev))
    pi = torch.as_tensor(pairs, device=dev)
    raw_k = mk.match_pairs_kernel(desc_bf, m, pi)
    torch.cuda.synchronize()
    raw_p = mk.match_pairs_plain(desc_bf, m, pi)
    if all(torch.equal(a, b) for a, b in zip(raw_k, raw_p)):
        return raw_k
    vk = mk.decide(raw_k, m, pi, ratio)[1]
    vp = mk.decide(raw_p, m, pi, ratio)[1]
    assert (vk == vp).float().mean().item() > 0.999
    both = vk & vp
    assert torch.equal(raw_k[1][both], raw_p[1][both])
    return raw_k


# name -> (N, K, pairs): Kp = 128 (one tile, an odd number of column tiles),
# 384 (three), 1024 (the largest the deep path uses); one pair, a pair count
# that is a multiple of nothing, duplicate pairs and (i, i) pairs
CUDA_PAIRS_CASES = {
    "kp128_n3": (3, 128, [(0, 1), (0, 2), (1, 2)]),
    "kp384_one_pair": (3, 300, [(2, 0)]),
    "kp384_7_pairs": (5, 384, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 3), (2, 2)]),
    "kp1024_duplicates": (3, 1000, [(0, 1), (0, 1), (1, 0), (2, 2), (0, 1)]),
    "kp512_13_pairs": (6, 512, [(i % 6, (i * 5 + 1) % 6) for i in range(13)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_PAIRS_CASES))
def test_cuda_kernel_matches_plain_at_sizes(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, K, pairs = CUDA_PAIRS_CASES[case]
    desc, mask, _ = _fixture(np.random.default_rng(7), N=N, K=K)
    raw = _check_cuda_pairs_kernel(desc, mask, np.array(pairs, np.int32))
    assert raw[0].shape == (len(pairs), -(-K // 128) * 128)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [128, 300, 1024])
def test_cuda_kernel_bit_exact_at_sizes(K):
    """Exact inputs (every product sum exact): all six raw outputs equal the
    plain version's bit for bit at one, three and eight row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    desc, mask, pairs = _representable(3, N=4, K=K)
    dev = torch.device("cuda")
    desc_bf, m = mk.prepare(torch.as_tensor(desc, device=dev), torch.as_tensor(mask, device=dev))
    pi = torch.as_tensor(pairs, device=dev)
    raw_k = mk.match_pairs_kernel(desc_bf, m, pi)
    torch.cuda.synchronize()
    for a, b in zip(raw_k, mk.match_pairs_plain(desc_bf, m, pi)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_all_masked_frames():
    """A frame without a live keypoint: every output of its pairs is dead,
    no match; the other pairs are untouched by it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    desc, mask, _ = _fixture(np.random.default_rng(8), N=4, K=256)
    mask[1] = False
    pairs = np.array([(0, 1), (1, 2), (1, 1), (0, 2), (2, 3)], np.int32)
    raw = _check_cuda_pairs_kernel(desc, mask, pairs)
    dev = torch.device("cuda")
    _, m = mk.prepare(torch.as_tensor(desc, device=dev), torch.as_tensor(mask, device=dev))
    valid = mk.decide(raw, m, torch.as_tensor(pairs, device=dev), 0.8)[1]
    assert not bool(valid[:3].any()) and bool(valid[3:].any())
    assert bool((raw[0][:3] == mk.NEG).all()) and bool((raw[3][:3] == mk.NEG).all())
    all_dead = np.zeros_like(mask)
    raw = _check_cuda_pairs_kernel(desc, all_dead, pairs)
    assert all(bool((raw[i] == mk.NEG).all()) for i in (0, 2, 3, 5))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    desc, mask, pairs = _fixture(np.random.default_rng(0), N=9, K=200)
    pairs = np.concatenate([pairs, np.zeros((4, 2), np.int32)])
    dev = torch.device("cuda")
    desc_bf, m = mk.prepare(torch.as_tensor(desc, device=dev), torch.as_tensor(mask, device=dev))
    pi = torch.as_tensor(pairs, device=dev)
    before = mk.match_pairs_kernel.launches
    raw_k = mk.match_pairs_kernel(desc_bf, m, pi)
    torch.cuda.synchronize()
    assert mk.match_pairs_kernel.launches == before + 1
    raw_p = mk.match_pairs_plain(desc_bf, m, pi)
    vk = mk.decide(raw_k, m, pi, 0.8)[1]
    vp = mk.decide(raw_p, m, pi, 0.8)[1]
    assert (vk == vp).float().mean().item() > 0.999
    both = vk & vp
    assert torch.equal(raw_k[1][both], raw_p[1][both])


@pytest.mark.cuda
def test_cuda_kernel_bit_exact_on_exact_inputs():
    """Where every product sum is exact, all six raw outputs of the kernel
    equal the plain version's bit for bit, ties and padding rows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    desc, mask, pairs = _representable(2)
    dev = torch.device("cuda")
    desc_bf, m = mk.prepare(torch.as_tensor(desc, device=dev), torch.as_tensor(mask, device=dev))
    pi = torch.as_tensor(pairs, device=dev)
    raw_k = mk.match_pairs_kernel(desc_bf, m, pi)
    torch.cuda.synchronize()
    raw_p = mk.match_pairs_plain(desc_bf, m, pi)
    for a, b in zip(raw_k, raw_p):
        assert torch.equal(a, b)


def _pair_fixture(seed, K1=200, K2=170, D=256):
    """One pair with 120 true matches (tests/test_ops.py)."""
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(K2, D)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    d1 = np.zeros((K1, D), np.float32)
    d1[:120] = d2[:120] + 0.02 * rng.normal(size=(120, D)).astype(np.float32)
    d1[120:] = rng.normal(size=(K1 - 120, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    return d1, d2, rng.random(K1) > 0.15, rng.random(K2) > 0.15


def test_single_pair_matches_pallas_interpret_and_jnp(rng):
    """Equal ``valid`` and equal indices where valid, against both the
    Pallas kernel in interpret mode and the jnp matcher: the fixture's
    matches are far from any ratio-test tie, so fp32 summation order does
    not show (K1 = 200 pads to two row tiles, K2 = 170 is ragged)."""
    import jax.numpy as jnp
    from eacham_tpu.features.matching import match_pair as jax_match_pair
    from eacham_tpu.ops.match_kernel import match_pair_fused as jax_match_pair_fused

    d1, d2, m1, m2 = _pair_fixture(0)
    a, v = mk.match_pair_fused(*(torch.as_tensor(x) for x in (d1, d2, m1, m2)))
    assert a.shape == (200,) and a.dtype == torch.int32 and v.dtype == torch.bool
    args = tuple(jnp.asarray(x) for x in (d1, d2, m1, m2))
    for a_ref, v_ref in (jax_match_pair_fused(*args, interpret=True), jax_match_pair(*args)):
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(a.numpy()[v.numpy()], np.asarray(a_ref)[v.numpy()])
    assert v.sum() > 50


def test_single_pair_raw_outputs_equal_pallas_on_exact_inputs():
    """With exact arithmetic the decisions agree everywhere, ties and the
    cross-tile column merge included (K1 = 300: three row tiles; every
    entry is a multiple of 1/16, so every product sum is exact)."""
    import jax.numpy as jnp
    from eacham_tpu.ops.match_kernel import match_pair_fused as jax_match_pair_fused

    r = np.random.default_rng(3)
    d1 = (r.integers(-1, 2, size=(300, 256)) / 16.0).astype(np.float32)
    d2 = (r.integers(-1, 2, size=(170, 256)) / 16.0).astype(np.float32)
    d1[100:200] = d2[:100]                       # true matches among the ties
    m1, m2 = r.random(300) > 0.2, r.random(170) > 0.2
    a, v = mk.match_pair_fused(*(torch.as_tensor(x) for x in (d1, d2, m1, m2)), ratio=0.95)
    a_ref, v_ref = jax_match_pair_fused(*(jnp.asarray(x) for x in (d1, d2, m1, m2)),
                                        ratio=0.95, interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    assert v.any()


def test_single_pair_agrees_with_batched_plain_packing():
    """On one pair of equal, tile-aligned sizes the single-pair plain
    version (fp32 operands) and the batched one (bf16 operands) follow the
    same packing rule: on bf16-exact inputs all six raw outputs are equal."""
    r = np.random.default_rng(4)
    desc = torch.as_tensor((r.integers(-1, 2, size=(2, 256, 256)) / 16.0).astype(np.float32))
    mask = torch.as_tensor(r.random((2, 256)) > 0.2)
    desc_bf, m = mk.prepare(desc, mask)
    batched = mk.match_pairs_plain(desc_bf, m, torch.tensor([[0, 1]]))
    single = mk.match_pair_plain(desc[0], desc[1], mask[0], mask[1])
    for a, b in zip(batched, single):
        assert torch.equal(a[0], b)


def test_single_pair_wrapper_refuses_non_cuda_tensors():
    d1, d2, m1, m2 = (torch.as_tensor(x) for x in _pair_fixture(0))
    with pytest.raises(ValueError):
        mk.match_pair_kernel(d1, d2, m1, m2)
    assert mk.match_pair_kernel.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K1,K2", [(200, 170), (1024, 1024), (1, 3)])
def test_cuda_single_pair_kernel_matches_plain(K1, K2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    r = np.random.default_rng(5)
    # bf16-exact small-integer entries: every product sum is exact, so the
    # raw outputs must be equal bit for bit, ties included
    d1 = torch.as_tensor((r.integers(-1, 2, size=(K1, 256)) / 16.0).astype(np.float32), device=dev)
    d2 = torch.as_tensor((r.integers(-1, 2, size=(K2, 256)) / 16.0).astype(np.float32), device=dev)
    m1 = torch.as_tensor(r.random(K1) > 0.2, device=dev)
    m2 = torch.as_tensor(r.random(K2) > 0.2, device=dev)
    before = mk.match_pair_kernel.launches
    raw_k = mk.match_pair_kernel(d1, d2, m1, m2)
    torch.cuda.synchronize()
    assert mk.match_pair_kernel.launches == before + 1
    for a, b in zip(raw_k, mk.match_pair_plain(d1, d2, m1, m2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_single_pair_decisions_on_real_descriptors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    d1, d2, m1, m2 = (torch.as_tensor(x, device=dev) for x in _pair_fixture(1))
    a, v = mk.match_pair_fused(d1, d2, m1, m2)
    torch.cuda.synchronize()
    a_ref, v_ref = mk.match_pair_fused(d1.cpu(), d2.cpu(), m1.cpu(), m2.cpu())
    assert torch.equal(v.cpu(), v_ref) and torch.equal(a.cpu()[v_ref], a_ref[v_ref])
    assert int(v.sum()) > 50
