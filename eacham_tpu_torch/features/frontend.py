"""Feature-extraction frontend: batched detect + describe over frames
(port of eacham_tpu/features/frontend.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.features.descriptor import describe_from_stacks
from eacham_tpu_torch.features.detector import N_OCTAVES, detect_from_stacks, octave_stacks
from eacham_tpu_torch.utils import timer


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
    on ``device``. A span ``features.frontend`` of ``utils.timer``.
    """
    dev = resolve_device(device)
    with timer.span("features.frontend"):
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


@dataclass
class ClassicalFrontend:
    """Configuration-carrying wrapper of ``extract_features``: ``batch``
    frames a step, the last chunk padded with blank frames to ``batch`` as
    the reference pads it, the padding cut from the result."""

    max_keypoints: int = 1024
    contrast_threshold: float = 0.006
    batch: int = 8           # frames a step (bounds the scale-space memory)
    device: str | torch.device | None = "cuda"

    def __call__(self, images) -> tuple:
        dev = resolve_device(self.device)
        images = as_tensor(images, dev, torch.float32)
        n = images.shape[0]
        outs = []
        for s in range(0, n, self.batch):
            chunk = images[s:s + self.batch]
            pad = self.batch - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            outs.append(extract_features(chunk, max_keypoints=self.max_keypoints,
                                         contrast_threshold=self.contrast_threshold,
                                         device=dev))
        return tuple(torch.cat([o[i] for o in outs])[:n] for i in range(4))
