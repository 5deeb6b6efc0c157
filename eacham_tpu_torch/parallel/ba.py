"""Sharded bundle adjustment (port of eacham_tpu/parallel/ba.py).

The observation table is split over the mesh's ranks; each rank computes
its partial segment sums, in a fixed order over the layout of its own
slice (ba/core.py ``_layout``), and ``refine_ba``'s reduction (an
``all_reduce`` over the mesh's group, ``_reduce``) makes every rank hold
the full reduced camera system. Poses, points and intrinsics are
replicated, so every rank computes the same LM trajectory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from eacham_tpu_torch.ba.core import BAConfig, BAProblem, refine_ba
from eacham_tpu_torch.parallel.mesh import Mesh, shard_rows

_OBS = ("obs_cam", "obs_pt", "obs_uv", "obs_mask")


def refine_ba_sharded(prob: BAProblem, cfg: BAConfig, mesh: Mesh):
    """Distributed ``refine_ba``, the observation axis sharded (padding rows
    carry ``obs_mask=False``): the same results up to the order in which
    the ranks' partial sums are added, and on one rank the same bits as
    ``refine_ba``. Every rank passes the whole problem and keeps its own
    block."""
    O = prob.obs_cam.shape[0]
    pad, lo, hi = shard_rows(O, mesh)
    local = {}
    for name in _OBS:
        x = getattr(prob, name)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        local[name] = x[lo:hi]
    return refine_ba(prob._replace(**local), cfg, group=mesh.group)


def broadcast_state(tensors, mesh: Mesh, src: int = 0):
    """``tensors`` as rank ``src`` holds them, on every rank (bool tensors
    travel as uint8). The pipeline's replicated stages run on every rank;
    this makes their state agree before a sharded stage reads its shapes."""
    if mesh.group is None:
        return list(tensors)
    out = []
    for t in tensors:
        x = (t.to(torch.uint8) if t.dtype == torch.bool else t.clone()).contiguous()
        dist.broadcast(x, src=src, group=mesh.group)
        out.append(x.bool() if t.dtype == torch.bool else x)
    return out
