"""The difference-of-Gaussians frontend and ``run_sfm``'s own matching rule:
keypoints and descriptors re-derived in float64 (``reference.frontend``;
control "tf32": TF32 convolutions), matches by mutual nearest neighbours
with Lowe's ratio test (``reference.matcher``; controls "fp8" and
"no_ratio")."""

from __future__ import annotations

import torch

from sfmbench.reference import frontend
from sfmbench.reference.judge import compare_features
from sfmbench.reference.matcher import reference_matches  # noqa: F401  (this kind's matcher)


def judge_frontend(images, out, frames, fe, control=None):
    """Keypoints and descriptors of ``frames`` against the float64 reference
    (``judge.compare_features``)."""
    imgs = images[frames]
    rxy, rdesc, rlive = frontend.extract(imgs, fe["max_keypoints"], fe["contrast_threshold"])
    if control == "tf32":
        xy, desc, mask = frontend.extract(imgs, fe["max_keypoints"], fe["contrast_threshold"],
                                          torch.float32, tf32=True)
    else:
        xy, desc, mask = out["xy"][frames], out["desc"][frames], out["mask"][frames]
    return compare_features(xy, desc, mask, rxy, rdesc, rlive)
