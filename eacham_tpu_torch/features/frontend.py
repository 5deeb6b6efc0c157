"""Feature-extraction frontend: batched detect + describe over frames
(port of eacham_tpu/features/frontend.py)."""

from __future__ import annotations

import torch

from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.features.descriptor import describe_from_stacks
from eacham_tpu_torch.features.detector import N_OCTAVES, detect_from_stacks, octave_stacks


@torch.no_grad()
def extract_features(
    images,                       # [N, H, W] grayscale float32 in [0, 1]
    max_keypoints: int = 1024,
    contrast_threshold: float = 0.006,
    frame_chunk: int = 8,
    device: str | torch.device | None = "cuda",
):
    """Detect + describe for a batch of frames, ``frame_chunk`` at a time
    (the scale-space and orientation temporaries are O(chunk * H * W *
    levels)). The Gaussian pyramid is built once per frame and shared by
    the detector and the descriptor.

    Returns ``(xy [N, K, 2], desc [N, K, 256], score [N, K], mask [N, K])``
    on ``device``.
    """
    dev = resolve_device(device)
    images = as_tensor(images, dev, torch.float32)
    outs = []
    for s in range(0, images.shape[0], frame_chunk):
        stacks = octave_stacks(images[s:s + frame_chunk], N_OCTAVES)
        xy, sidx, score, mask = detect_from_stacks(
            stacks, max_keypoints=max_keypoints,
            contrast_threshold=contrast_threshold)
        desc = describe_from_stacks(stacks, xy, sidx, mask)
        outs.append((xy, desc, score, mask))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))
