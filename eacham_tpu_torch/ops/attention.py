"""Masked multi-head attention: the CUDA kernel, its wrapper, its plain
PyTorch version and the differentiable dispatcher (port of
eacham_tpu/ops/attention.py).

The compute core of the LightGlue-class matcher. Keypoint sets are short
(N <= 2048) and heads are 64 wide; the kernel (csrc/masked_attention.cu)
fuses q k^T -> masked softmax -> p v per (batch, head, query tile) with an
online softmax over key tiles, so no [N, N] score tensor reaches device
memory. ``mask_kv`` False keys contribute nothing; a query row whose keys
are all masked returns exact zeros.

Layout as in the reference: q [B, H, Nq, D], k, v [B, H, Nk, D],
mask_kv [B, Nk] bool, output [B, H, Nq, D]. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises — there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIM = 64
NEG = -1e30


def _masked_probs(q: torch.Tensor, k: torch.Tensor, mask_kv: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) over the live keys, [B, H, Nq, Nk]; dead
    keys, and every key of a row without a live one, get exactly 0."""
    live = mask_kv[:, None, None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / (q.shape[-1] ** 0.5)
    p = torch.softmax(torch.where(live, s, NEG), dim=-1)
    return torch.where(live, p, 0.0)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_kv: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops (the reference's
    ``masked_attention_reference``)."""
    return torch.einsum("bhqk,bhkd->bhqd", _masked_probs(q, k, mask_kv), v)


def _check(name: str, t: torch.Tensor, shape, dev) -> None:
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned fp32 tensor of shape "
                         f"{tuple(shape)} on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask_kv: torch.Tensor):
    """Raise ValueError on anything the kernel does not take: q, k, v must be
    contiguous, 16-byte aligned fp32 tensors [B, H, N, 64] on one device,
    mask_kv a contiguous [B, Nk] bool tensor there. Returns (B, H, Nq, Nk)."""
    if q.dim() != 4 or q.shape[3] != HEAD_DIM:
        raise ValueError(f"q must be [B, H, Nq, {HEAD_DIM}]; got {tuple(q.shape)}")
    B, H, Nq, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"k must be [B, H, Nk, {HEAD_DIM}]; got {tuple(k.shape)}")
    Nk = k.shape[2]
    _check("q", q, (B, H, Nq, D), q.device)
    _check("k", k, (B, H, Nk, D), q.device)
    _check("v", v, (B, H, Nk, D), q.device)
    if mask_kv.dtype != torch.bool or tuple(mask_kv.shape) != (B, Nk) \
            or mask_kv.device != q.device or not mask_kv.is_contiguous():
        raise ValueError(f"mask_kv must be a contiguous [B, Nk] = {(B, Nk)} bool tensor "
                         f"on {q.device}")
    return B, H, Nq, Nk


def masked_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask_kv: torch.Tensor) -> torch.Tensor:
    """Launch csrc/masked_attention.cu on CUDA tensors; same contract as
    ``masked_attention_plain``. Counts its launches in ``.launches``."""
    from eacham_tpu_torch.ops.build import load

    if not q.is_cuda:
        raise ValueError("masked_attention_kernel takes CUDA tensors")
    B, H, Nq, Nk = check_kernel_args(q, k, v, mask_kv)

    lib = load("masked_attention")
    lib.masked_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.masked_attention_error_string.restype = ctypes.c_char_p
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = lib.masked_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_kv.data_ptr(),
            out.data_ptr(), B, H, Nq, Nk,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("masked_attention kernel launch failed: "
                           + lib.masked_attention_error_string(err).decode())
    masked_attention_kernel.launches += 1
    return out


masked_attention_kernel.launches = 0


def masked_attention(q, k, v, mask_kv) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors, and
    an error for anything else."""
    if q.is_cuda:
        return masked_attention_kernel(q, k, v, mask_kv)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, mask_kv)
    raise ValueError(f"no attention for device {q.device}")


class _Attention(torch.autograd.Function):
    """Forward through ``masked_attention``; the backward recomputes the
    masked probabilities and propagates the softmax-attention gradients
    with einsums, as the reference's custom VJP does (it has no backward
    kernel either)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kv):
        ctx.save_for_backward(q, k, v, mask_kv)
        return masked_attention(q, k, v, mask_kv)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask_kv = ctx.saved_tensors
        scale = 1.0 / (q.shape[-1] ** 0.5)
        p = _masked_probs(q, k, mask_kv)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
        dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask_kv: torch.Tensor) -> torch.Tensor:
    """Differentiable masked attention: softmax(q k^T / sqrt(D)) v over the
    live keys. Returns [B, H, Nq, D]."""
    return _Attention.apply(q, k, v, mask_kv)
