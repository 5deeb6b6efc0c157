"""The port's masked attention (eacham_tpu_torch.ops.attention) against the
JAX package's Pallas kernel run in interpret mode and its jnp reference,
on the CPU.

On the CPU the port runs the kernel's plain PyTorch version; the CUDA
kernel itself is compared with that plain version by the tests marked
``cuda``, which run only where a card is present. The JAX package is
imported inside the tests that use it, so that the ``cuda`` tests also run
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from eacham_tpu_torch.ops import attention as at

torch.set_num_threads(2)

# B, H, Nq, Nk, share of live keys: the three cases of tests/test_ops.py
CASES = {"self": (2, 4, 200, 200, 0.7), "cross_ragged": (1, 2, 130, 70, 0.5)}


def _inputs(seed, B, H, Nq, Nk, live):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Nq, 64)).astype(np.float32)
    k = rng.normal(size=(B, H, Nk, 64)).astype(np.float32)
    v = rng.normal(size=(B, H, Nk, 64)).astype(np.float32)
    mask = rng.random((B, Nk)) < live
    return q, k, v, mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret_and_reference(case):
    """atol 1e-5, the tolerance the JAX package holds its kernel to: both
    sides are fp32 and differ in summation order only."""
    import jax.numpy as jnp
    from eacham_tpu.ops.attention import masked_attention, masked_attention_reference

    q, k, v, mask = _inputs(0, *CASES[case])
    out = at.attention(*(torch.as_tensor(a) for a in (q, k, v, mask))).numpy()
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    assert out.shape == q.shape
    np.testing.assert_allclose(out, np.asarray(masked_attention(jq, jk, jv, jm, interpret=True)),
                               atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(masked_attention_reference(jq, jk, jv, jm)),
                               atol=1e-5)


def test_plain_fully_masked_batch_is_exact_zero():
    import jax.numpy as jnp
    from eacham_tpu.ops.attention import masked_attention

    q, k, v, _ = _inputs(0, 2, 1, 64, 64, 1.0)
    mask = np.zeros((2, 64), bool)
    mask[1] = True
    out = at.masked_attention_plain(*(torch.as_tensor(a) for a in (q, k, v, mask)))
    assert bool(out.isfinite().all())
    assert float(out[0].abs().max()) == 0.0
    ref = np.asarray(masked_attention(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                      interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_autograd_function_matches_jax_grad():
    """The hand-written backward against jax.grad through the reference
    (atol 1e-4, as tests/test_ops.py), and against torch's own autograd
    through the plain version."""
    import jax
    import jax.numpy as jnp
    from eacham_tpu.ops.attention import masked_attention_reference

    q, k, v, mask = _inputs(0, 1, 2, 32, 32, 0.7)

    def loss_ref(q, k, v):
        return jnp.sum(masked_attention_reference(q, k, v, jnp.asarray(mask)) ** 2)

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))

    def grads(fn):
        ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts, torch.as_tensor(mask)) ** 2).sum().backward()
        return [t.grad.numpy() for t in ts]

    for a, b, c in zip(grads(at.attention), g_ref, grads(at.masked_attention_plain)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
        np.testing.assert_allclose(a, c, atol=1e-4)


def test_wrapper_refuses_non_cuda_tensors():
    """The kernel wrapper never runs the plain version on its own."""
    q, k, v, mask = (torch.as_tensor(a) for a in _inputs(0, 1, 1, 8, 8, 1.0))
    with pytest.raises(ValueError):
        at.masked_attention_kernel(q, k, v, mask)
    assert at.masked_attention_kernel.launches == 0


def _misaligned(t):
    """The same values, contiguous, 4 bytes off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# what the kernel wrapper must refuse before it launches anything; the checks
# do not depend on the device, so they are held here on CPU tensors
BAD_ARGS = {
    "q_not_contiguous": lambda q, k, v, m: (q.transpose(1, 2), k, v, m),
    "q_strided_rows": lambda q, k, v, m: (q[:, :, ::2], k, v, m[:, :]),
    "fp64": lambda q, k, v, m: (q.double(), k.double(), v.double(), m),
    "k_half": lambda q, k, v, m: (q, k.half(), v, m),
    "head_dim_32": lambda q, k, v, m: (q[..., :32].contiguous(), k, v, m),
    "q_3d": lambda q, k, v, m: (q[0], k, v, m),
    "k_3d": lambda q, k, v, m: (q, k[0], v, m),
    "k_v_lengths_differ": lambda q, k, v, m: (q, k, v[:, :, :-1].contiguous(), m),
    "k_other_batch": lambda q, k, v, m: (q, k[:1], v[:1], m[:1]),
    "mask_too_short": lambda q, k, v, m: (q, k, v, m[:, :-1].contiguous()),
    "mask_not_bool": lambda q, k, v, m: (q, k, v, m.to(torch.uint8)),
    "mask_not_contiguous": lambda q, k, v, m: (q, k, v, m.t().contiguous().t()),
    "q_misaligned": lambda q, k, v, m: (_misaligned(q), k, v, m),
    "v_misaligned": lambda q, k, v, m: (q, k, _misaligned(v), m),
    "k_other_device": lambda q, k, v, m: (q, k.to("meta"), v, m),
    "mask_other_device": lambda q, k, v, m: (q, k, v, m.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_argument_checks_refuse(case):
    good = tuple(torch.as_tensor(a) for a in _inputs(0, 2, 2, 12, 10, 0.5))
    assert at.check_kernel_args(*good) == (2, 2, 12, 10)
    with pytest.raises(ValueError):
        at.check_kernel_args(*BAD_ARGS[case](*good))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the deep path's shape, then the ragged and the small cases
CUDA_CASES = {"main_path": (4, 4, 1024, 1024, 0.8), "self": CASES["self"],
              "cross_ragged": CASES["cross_ragged"], "one_key": (1, 1, 5, 1, 1.0),
              "dead_tiles": (2, 4, 300, 300, 0.02),
              # the kernel's key tile is 32 wide, its query tile 128 tall
              "nk_under_a_tile": (2, 4, 200, 7, 1.0), "nk_tile_plus_one": (2, 4, 200, 33, 1.0),
              "nk_two_tiles_plus_one": (1, 2, 129, 65, 0.9), "nq_one": (3, 4, 1, 100, 0.6),
              "nq_tile_plus_one": (1, 4, 129, 64, 1.0)}


def _mask_last_tile_only(mask):
    """Live keys only in the last 32-key tile."""
    mask[:, : (mask.shape[1] - 1) // 32 * 32] = False
    mask[:, -1] = True


def _mask_dead_tiles_in_the_middle(mask):
    """Whole dead key tiles between live ones."""
    mask[:, 32:160] = False
    mask[:, 224:256] = False
    mask[:, 0] = True
    mask[:, -1] = True


def _mask_dead_batch_entry(mask):
    mask[0] = False


# name -> (B, H, Nq, Nk, live share, edit of the random mask)
CUDA_MASKS = {"last_tile_only": (2, 4, 150, 300, 0.7, _mask_last_tile_only),
              "last_tile_only_ragged": (2, 2, 64, 333, 0.7, _mask_last_tile_only),
              "dead_tiles_in_the_middle": (2, 4, 150, 300, 0.7, _mask_dead_tiles_in_the_middle),
              "dead_batch_entry": (3, 4, 130, 70, 0.5, _mask_dead_batch_entry)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(case):
    dev = _need_card()
    q, k, v, mask = (torch.as_tensor(a, device=dev) for a in _inputs(1, *CUDA_CASES[case]))
    before = at.masked_attention_kernel.launches
    out = at.masked_attention_kernel(q, k, v, mask)
    torch.cuda.synchronize()
    assert at.masked_attention_kernel.launches == before + 1
    ref = at.masked_attention_plain(q, k, v, mask)
    assert float((out - ref).abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_MASKS))
def test_cuda_kernel_matches_plain_on_structured_masks(case):
    """atol 1e-5 as above; rows of a batch entry without a live key are
    exact zeros."""
    dev = _need_card()
    *shape, edit = CUDA_MASKS[case]
    q, k, v, mask = _inputs(3, *shape)
    edit(mask)
    q, k, v, mask = (torch.as_tensor(a, device=dev) for a in (q, k, v, mask))
    out = at.masked_attention_kernel(q, k, v, mask)
    torch.cuda.synchronize()
    assert bool(out.isfinite().all())
    assert float((out - at.masked_attention_plain(q, k, v, mask)).abs().max()) < 1e-5
    dead = ~mask.any(1)
    if bool(dead.any()):
        assert float(out[dead].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_kernel_fully_masked_batch_and_checks():
    dev = _need_card()
    q, k, v, _ = (torch.as_tensor(a, device=dev) for a in _inputs(2, 2, 4, 130, 70, 1.0))
    mask = torch.zeros((2, 70), dtype=torch.bool, device=dev)
    mask[1, 3:] = True
    out = at.attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0 and bool(out.isfinite().all())
    assert float((out - at.masked_attention_plain(q, k, v, mask)).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        at.masked_attention_kernel(q.transpose(1, 2), k, v, mask)      # not contiguous
    with pytest.raises(ValueError):
        at.masked_attention_kernel(q.double(), k.double(), v.double(), mask)
    with pytest.raises(ValueError):
        at.masked_attention_kernel(q, k, v, mask[:, :-1])
