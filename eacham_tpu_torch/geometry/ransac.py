"""Batched fixed-iteration MSAC (port of eacham_tpu/geometry/ransac.py).

All hypotheses of all problems in a batch are sampled, solved and scored
in one pass of tensor ops. Leading axes of the data are batch axes: one
call verifies every frame pair of a chunk at once.

Torch cannot reproduce JAX's random stream, so every entry point also
takes precomputed ``sample_idx``; the parity tests pass in the indices the
JAX package drew.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor       # [..., *model] best model parameters
    inliers: torch.Tensor     # [..., N] bool inlier mask against the data
    n_inliers: torch.Tensor   # [...] int64
    score: torch.Tensor       # [...] float32 MSAC score (lower is better)


def draw_uniforms(generator: torch.Generator | None, batch: tuple, n_hyp: int, n: int,
                  device) -> torch.Tensor:
    """The iid uniforms [*batch, n_hyp, n] that ``masked_sample_indices``
    draws for a mask [*batch, n]: one draw from ``generator``."""
    return torch.rand(tuple(batch) + (n_hyp, n), generator=generator, device=device)


def masked_sample_indices(generator: torch.Generator | None, mask: torch.Tensor,
                          n_hyp: int, sample_size: int,
                          uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """``n_hyp`` tuples of ``sample_size`` distinct indices of ``mask``-valid
    rows, per problem: [..., N] -> [..., n_hyp, sample_size].

    Gumbel-top-k as in the reference: iid uniforms (``uniforms`` where
    given, else drawn from ``generator``), invalid rows pushed to -inf, top-k
    per hypothesis (no rejection loop).
    """
    u = uniforms
    if u is None:
        u = draw_uniforms(generator, mask.shape[:-1], n_hyp, mask.shape[-1], mask.device)
    u = torch.where(mask[..., None, :], u, float("-inf"))
    return torch.topk(u, sample_size, dim=-1).indices


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``x`` [..., N, C] by ``idx`` [..., *J] (same leading
    batch axes) -> [..., *J, C]."""
    batch = x.shape[:-2]
    nb = len(batch)
    flat = idx.reshape(idx.shape[:nb] + (-1,)).long()
    out = torch.gather(
        x, -2, flat[..., None].expand(flat.shape + (x.shape[-1],)))
    return out.reshape(idx.shape + (x.shape[-1],))


def take_along(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x [..., H, *rest], best [...] -> x[..., best, *rest]."""
    nb = best.dim()
    rest = x.shape[nb + 1:]
    ix = best.reshape(best.shape + (1,) * (1 + len(rest))).expand(
        best.shape + (1,) + rest)
    return torch.gather(x, nb, ix).squeeze(nb)


def ransac(
    data_mask: torch.Tensor,        # [..., N] bool — valid correspondences
    solver: Callable,               # idx [..., H, S] -> models [..., H, *model]
    residual: Callable,             # models -> [..., H, N] residuals
    threshold: float,
    n_hyp: int,
    sample_size: int,
    generator: torch.Generator | None = None,
    sample_idx: torch.Tensor | None = None,   # [..., H, S], overrides sampling
    uniforms: torch.Tensor | None = None,     # [..., H, N], the sampler's draw
) -> RansacResult:
    """Generic batched MSAC; invalid data never count as inliers."""
    if sample_idx is None:
        sample_idx = masked_sample_indices(generator, data_mask, n_hyp, sample_size, uniforms)
    models = solver(sample_idx.long())
    r = residual(models)
    r2 = r * r
    t2 = threshold * threshold
    dm = data_mask[..., None, :]
    inl = (r2 < t2) & dm
    # MSAC: inliers contribute r^2, outliers t^2
    scores = torch.sum(torch.where(inl, r2, t2) * dm, dim=-1)
    # torch.argmin returns the FIRST minimum on ties, as jnp.argmin does
    best = torch.argmin(scores, dim=-1)
    best_inl = take_along(inl, best)
    return RansacResult(
        model=take_along(models, best),
        inliers=best_inl,
        n_inliers=best_inl.sum(-1),
        score=take_along(scores, best),
    )
