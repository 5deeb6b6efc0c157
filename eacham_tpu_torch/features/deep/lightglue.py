"""LightGlue-class attentional keypoint matcher (port of
eacham_tpu/features/deep/lightglue.py).

L transformer layers of rotary-positional self-attention + cross-attention
over the two keypoint sets, then a matchability head and a dual-softmax
partial assignment. All attention runs through
``eacham_tpu_torch.ops.attention`` (the CUDA kernel on the card).

Inputs: keypoints normalized to ~[-1, 1] by max(w, h)/2 around the image
center, 256-d descriptors. Outputs: per-keypoint match index + score;
matches kept when score > threshold and mutual. Module names follow the
reference's parameter tree (``self0_0`` ... ``match1``,
``desc_sim_gain``), so ``convert.lightglue_from_numpy`` carries its
weights across. ``init_params`` initialises it as flax does;
``save_params`` / ``load_params`` write and read the reference's ``.npz``
layout for either network, so a file written by either package loads in
the other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eacham_tpu_torch.features.deep.superpoint import SuperPointNet, lecun_init_
from eacham_tpu_torch.ops.attention import attention
from eacham_tpu_torch.utils import timer

DIM = 256
HEADS = 4
HEAD_DIM = DIM // HEADS
MATCH_THRESHOLD = 0.5
LN_EPS = 1e-6             # the reference's LayerNorm epsilon (torch's default is 1e-5)


def normalize_keypoints(uv: torch.Tensor, width: float, height: float):
    """Center + scale to ~[-1, 1] by max(w, h)/2."""
    size = timer.readback(torch.tensor, [width, height], dtype=uv.dtype, device=uv.device)
    return (uv - size / 2.0) / (size.max() / 2.0)


def _rotary(coords: torch.Tensor, n_freq: int = HEAD_DIM // 4):
    """2-D rotary embedding angles from normalized coords [..., 2]."""
    freqs = 2.0 ** torch.arange(n_freq, dtype=coords.dtype, device=coords.device)
    ang = coords[..., None, :] * freqs[:, None]             # [..., F, 2]
    return ang.reshape(*coords.shape[:-1], 2 * n_freq)      # [..., 2F]


def _apply_rotary(x: torch.Tensor, ang: torch.Tensor):
    """Rotate feature pairs of x [..., H, N, D] by angles ang [..., N, D/2]."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = torch.cos(ang)[..., None, :, :]
    sin = torch.sin(ang)[..., None, :, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


class AttentionBlock(nn.Module):
    """One residual attention unit (queries from x, keys/values from y)."""

    def __init__(self):
        super().__init__()
        self.ln_x = nn.LayerNorm(DIM, eps=LN_EPS)     # pre-norm
        self.ln_y = nn.LayerNorm(DIM, eps=LN_EPS)
        self.q = nn.Linear(DIM, DIM)
        self.k = nn.Linear(DIM, DIM)
        self.v = nn.Linear(DIM, DIM)
        self.proj = nn.Linear(DIM, DIM)
        self.ln_m = nn.LayerNorm(2 * DIM, eps=LN_EPS)
        self.mlp1 = nn.Linear(2 * DIM, 2 * DIM)
        self.mlp2 = nn.Linear(2 * DIM, DIM)

    def forward(self, x, y, mask_y, ang_x=None, ang_y=None):
        B, N, _ = x.shape
        xn = self.ln_x(x)
        yn = self.ln_y(y)
        q = self.q(xn).reshape(B, N, HEADS, HEAD_DIM).transpose(1, 2)
        k = self.k(yn).reshape(B, -1, HEADS, HEAD_DIM).transpose(1, 2)
        v = self.v(yn).reshape(B, -1, HEADS, HEAD_DIM).transpose(1, 2)
        if ang_x is not None:
            q = _apply_rotary(q, ang_x)
            k = _apply_rotary(k, ang_y)
        # the kernel takes [B, H, N, D] as it lies in memory
        timer.add("attention_calls")
        o = attention(q.contiguous(), k.contiguous(), v.contiguous(), mask_y.contiguous())
        o = self.proj(o.transpose(1, 2).reshape(B, N, DIM))
        # gated MLP on the concatenated message (LightGlue-style update)
        m = self.ln_m(torch.cat([xn, o], -1))
        m = self.mlp2(F.gelu(self.mlp1(m), approximate="tanh"))
        return x + m


class LightGlueMatcher(nn.Module):
    """L layers of (rotary self-attn, cross-attn) + assignment heads."""

    def __init__(self, n_layers: int = 6):
        super().__init__()
        self.n_layers = n_layers
        self.in_proj = nn.Linear(DIM, DIM)            # shared across both images
        for i in range(n_layers):
            for name in ("self0", "self1", "cross0", "cross1"):
                setattr(self, f"{name}_{i}", AttentionBlock())
        self.final0 = nn.Linear(DIM, DIM)
        self.final1 = nn.Linear(DIM, DIM)
        self.match0 = nn.Linear(DIM, 1)
        self.match1 = nn.Linear(DIM, 1)
        # residual descriptor-similarity bias: at init the matcher behaves
        # like a plain dot-product matcher and training can only refine it
        self.desc_sim_gain = nn.Parameter(torch.full((), 5.0))

    def similarity(self, kps0, desc0, mask0, kps1, desc1, mask1):
        """Transformer trunk -> raw pairwise similarity + matchabilities.

        Returns (sim [B, N0, N1] masked logits, m0 [B, N0], m1 [B, N1]).
        """
        x0 = self.in_proj(desc0)
        x1 = self.in_proj(desc1)
        ang0 = _rotary(kps0)
        ang1 = _rotary(kps1)

        for i in range(self.n_layers):
            x0 = getattr(self, f"self0_{i}")(x0, x0, mask0, ang0, ang0)
            x1 = getattr(self, f"self1_{i}")(x1, x1, mask1, ang1, ang1)
            x0n, x1n = x0, x1
            x0 = getattr(self, f"cross0_{i}")(x0n, x1n, mask1)
            x1 = getattr(self, f"cross1_{i}")(x1n, x0n, mask0)

        f0 = self.final0(x0)
        f1 = self.final1(x1)
        m0 = torch.sigmoid(self.match0(x0))[..., 0]       # [B, N0]
        m1 = torch.sigmoid(self.match1(x1))[..., 0]

        sim = torch.einsum("bnd,bmd->bnm", f0, f1) / (DIM ** 0.5)
        d0n = desc0 / (torch.linalg.vector_norm(desc0, dim=-1, keepdim=True) + 1e-8)
        d1n = desc1 / (torch.linalg.vector_norm(desc1, dim=-1, keepdim=True) + 1e-8)
        sim = sim + self.desc_sim_gain * torch.einsum("bnd,bmd->bnm", d0n, d1n)
        sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim, -1e9)
        return sim, m0, m1

    def forward(self, kps0, desc0, mask0, kps1, desc1, mask1):
        """kps: [B, N, 2] normalized; desc: [B, N, 256]; mask: [B, N].

        Returns (scores [B, N0, N1] assignment probabilities,
        matchability0 [B, N0], matchability1 [B, N1]).
        """
        sim, m0, m1 = self.similarity(kps0, desc0, mask0, kps1, desc1, mask1)
        # dual-softmax partial assignment weighted by matchability
        p0 = torch.softmax(sim, dim=2)
        p1 = torch.softmax(sim, dim=1)
        scores = p0 * p1 * m0[:, :, None] * m1[:, None, :]
        scores = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, 0.0)
        return scores, m0, m1


def extract_matches(scores, mask0, mask1, threshold: float = MATCH_THRESHOLD):
    """Assignment -> per-kp0 match index with mutual check + threshold.

    Returns (idx [B, N0] int32, valid [B, N0]). ``torch.argmax`` returns the
    first maximum, as the reference's argmax does; rows of masked keypoints
    score all zeros and point at column 0.
    """
    best0 = torch.argmax(scores, dim=2)                      # [B, N0]
    best1 = torch.argmax(scores, dim=1)                      # [B, N1]
    s = torch.gather(scores, 2, best0[..., None])[..., 0]
    mutual = torch.gather(best1, 1, best0) \
        == torch.arange(scores.shape[1], device=scores.device)[None, :]
    valid = mutual & (s > threshold) & mask0
    return best0.to(torch.int32), valid


@torch.no_grad()
def match_deep(model: LightGlueMatcher, kps0, desc0, mask0, kps1, desc1, mask1,
               threshold: float = MATCH_THRESHOLD):
    """Full deep matching: returns (idx [B, N0], valid [B, N0], scores)."""
    scores, _, _ = model(kps0, desc0, mask0, kps1, desc1, mask1)
    idx, valid = extract_matches(scores, mask0, mask1, threshold)
    return idx, valid, scores


def init_params(generator: torch.Generator, n_layers: int = 6, n_kps: int = 64) -> LightGlueMatcher:
    """A LightGlueMatcher initialised as the reference's ``init_params`` does
    (on the CPU): lecun-normal dense kernels, zero biases, LayerNorm scales 1
    and biases 0, ``desc_sim_gain`` 5. ``n_kps`` is the reference's dummy
    input size: it shapes no parameter."""
    del n_kps
    return lecun_init_(LightGlueMatcher(n_layers=n_layers), generator)


def save_params(path, model: nn.Module) -> None:
    """Write a SuperPointNet's or LightGlueMatcher's parameters to ``path``
    as the reference's ``save_params`` does: one array per leaf, keyed by
    its path (``"['params']/['self0_0']/['q']/['kernel']"``), in the
    reference's layouts and in the module's dtype. The path is the caller's."""
    from eacham_tpu_torch import convert

    if isinstance(model, LightGlueMatcher):
        flat = convert.lightglue_to_numpy(model)
    elif isinstance(model, SuperPointNet):
        flat = convert.superpoint_to_numpy(model)
    else:
        raise TypeError(f"no parameter layout for {type(model).__name__}")
    np.savez(path, **dict(sorted(flat.items())))


def load_params(path, like: nn.Module, dtype=None) -> nn.Module:
    """A new module of ``like``'s kind (and depth), on ``like``'s device in
    eval mode, holding the parameters of an ``.npz`` written by either
    package's ``save_params``. ``dtype`` (a torch or numpy dtype): cast on
    the host before the copy to the device. Every array of the file must
    have its place in the module."""
    from eacham_tpu_torch import convert

    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if isinstance(like, LightGlueMatcher):
        model = convert.lightglue_from_numpy(flat, like.n_layers)
    elif isinstance(like, SuperPointNet):
        model = convert.superpoint_from_numpy(flat)
    else:
        raise TypeError(f"no parameter layout for {type(like).__name__}")
    if dtype is not None:
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        model = model.to(dtype)
    return model.to(next(like.parameters()).device)
