"""Absolute pose references (GPS priors / surveyed cameras); port of
eacham_tpu/sfm/anchors.py, host numpy (the measurements quoted are the
JAX package's).

The reconstruction's relative measurements cannot observe low-frequency
drift (SCALING.md 1000-frame analysis: the residual warp lives in the
near-nullspace of every pairwise constraint); absolute references remove
it. Express references in the reconstruction's own frame with
``anchors_in_estimate_frame`` and pass the result to
``run_sfm``/``resume_sfm`` as ``abs_anchors=(poses, mask)``; every
global/refine bundle adjustment then adds tight se(3) priors on the
anchored frames (ba/core.py). Measured at N=1000: 5 anchors collapse
ATE 2.04 -> 0.033 (scripts/anchor_probe.py).

No reference counterpart: the reference's only priors anchor to the
estimate itself (BundleAdjuster.cpp:60-77).
"""

from __future__ import annotations

import numpy as np

from eacham_tpu_torch.device import to_numpy
from eacham_tpu_torch.utils.evaluate import align_umeyama


def anchors_in_estimate_frame(est_poses, ref_poses, anchor_ids, valid=None):
    """Map externally-known reference poses into the estimate's frame.

    est_poses: [N, 4, 4] world->cam current estimates (tensors on any
        device or arrays, as every argument).
    ref_poses: [N, 4, 4] world->cam references (e.g. GPS/surveyed), in
        their own metric frame.
    anchor_ids: frame indices to anchor.
    valid: optional [N] bool — registered frames; the similarity fit uses
        only these (unregistered identity poses would skew it).

    Returns (anchor_poses [N, 4, 4] float32, anchor_mask [N] bool) ready
    for ``run_sfm(abs_anchors=...)``. Rows outside ``anchor_ids`` are
    identity (the BA masks them out; identity keeps them invertible).
    """
    est_poses = to_numpy(est_poses)
    ref_poses = to_numpy(ref_poses)
    c_est = -np.einsum("nij,ni->nj", est_poses[:, :3, :3],
                       est_poses[:, :3, 3])
    c_ref = -np.einsum("nij,ni->nj", ref_poses[:, :3, :3],
                       ref_poses[:, :3, 3])
    fit = (np.ones(len(c_est), bool) if valid is None
           else to_numpy(valid).astype(bool))
    # similarity mapping est -> ref; inverted to express refs in est frame
    s, R, t = align_umeyama(c_est[fit].astype(np.float64),
                            c_ref[fit].astype(np.float64))
    anchors = np.broadcast_to(np.eye(4, dtype=np.float32),
                              est_poses.shape).copy()
    mask = np.zeros(len(est_poses), bool)
    for i in to_numpy(anchor_ids).ravel():
        c_a = (R.T @ (c_ref[i] - t)) / s
        R_a = ref_poses[i][:3, :3] @ R
        anchors[i, :3, :3] = R_a
        anchors[i, :3, 3] = -R_a @ c_a
        mask[i] = True
    return anchors.astype(np.float32), mask
