"""The difference-of-Gaussians frontend (``features.frontend.extract_features``)
ahead of ``run_sfm``'s own match graph (kernel 1, then epipolar
verification: ``sfm.matches.build_match_tables``)."""

from __future__ import annotations

STREAMS = True      # StreamingReconstructor extracts with extract_features itself


def setup(prog):
    return None


def kernels(config: dict) -> list[str]:
    return ["match_pairs"]


def extract(prog, images):
    from eacham_tpu_torch.features.frontend import extract_features

    fe = prog.config["frontend"]
    xy, desc, _, mask = extract_features(
        images, max_keypoints=fe["max_keypoints"],
        contrast_threshold=fe["contrast_threshold"], device=prog.dev)
    return xy, desc, mask


def match_tables(prog, xy, desc, mask, opts, generator):
    return None
