"""Streaming frame sources, the reference's SENSOR source type (port of
eacham_tpu/io/stream.py).

The reference distinguishes DATASET vs SENSOR sources
(modules/base/data_source/DataSourceTypes.h:7-18) with a Realsense replay
config (config/ConfigRealsense.json) its parser cannot read (SURVEY.md §2
#34). Here a streaming source is anything satisfying ``FrameSource``:
``read()`` yields frames until None (ICamera::Read's contract,
ICamera.h:17-57). ``drain`` collects a stream into the padded batch the
pipeline consumes — the analogue of SfmInputSource::GetAll
(SfmInputSource.h:18-40), including ``max_frames``.

``ReplaySource`` replays an image directory at sensor pace (optionally
respecting a timestamp file) — the hardware-free stand-in for a live
camera; a real sensor integration only needs to implement ``read``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterator, Protocol

import numpy as np

from eacham_tpu_torch.io.images import ImageBatch, list_images, _decode_one


class FrameSource(Protocol):
    def read(self) -> tuple[int, np.ndarray, str] | None:
        """Next (id, grayscale float image, name) or None when exhausted."""
        ...


class ReplaySource:
    """Replay an image directory as a stream (optionally timed)."""

    def __init__(self, directory: str | Path, realtime: bool = False,
                 fps: float = 30.0):
        self.files = list_images(directory)
        self.pos = 0
        self.realtime = realtime
        self.period = 1.0 / fps
        self._last = 0.0

    def read(self):
        if self.pos >= len(self.files):
            return None
        if self.realtime:
            now = time.perf_counter()
            wait = self._last + self.period - now
            if wait > 0:
                time.sleep(wait)
            self._last = time.perf_counter()
        path = self.files[self.pos]
        gray, _ = _decode_one(path, False)
        frame = (self.pos, gray, path.name)
        self.pos += 1
        return frame


def frames(source: FrameSource) -> Iterator[tuple[int, np.ndarray, str]]:
    while True:
        item = source.read()
        if item is None:
            return
        yield item


def drain(source: FrameSource, max_frames: int = 0) -> ImageBatch:
    """Collect a stream into one padded ImageBatch (GetAll parity)."""
    collected = []
    names = []
    for idx, img, name in frames(source):
        collected.append(img)
        names.append(name)
        if max_frames > 0 and len(collected) >= max_frames:
            break
    if not collected:
        raise RuntimeError("stream produced no frames")
    H = max(g.shape[0] for g in collected)
    W = max(g.shape[1] for g in collected)
    images = np.zeros((len(collected), H, W), np.float32)
    sizes = np.zeros((len(collected), 2), np.int32)
    for i, g in enumerate(collected):
        images[i, :g.shape[0], :g.shape[1]] = g
        sizes[i] = (g.shape[1], g.shape[0])
    return ImageBatch(images=images, sizes=sizes, names=names)
