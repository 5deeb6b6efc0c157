"""Debug visualization: match overlays saved to disk (port of
eacham_tpu/utils/viz.py, numpy and PIL only).

Offline replacement for the reference's cv::imshow debug helpers
(apps/sfm/view/Gui.h:13-62 DrawMatches; example binaries' overlays,
modules/onnx/lightglue/example/src/extract_match.cpp:60-66): draws the two
frames side by side with keypoints and match lines and writes a PNG.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def draw_matches(
    img1: np.ndarray,       # [H, W] grayscale float in [0, 1]
    img2: np.ndarray,
    uv1: np.ndarray,        # [K, 2]
    uv2: np.ndarray,        # [K, 2] (matched order: uv2[i] pairs with uv1[i])
    valid: np.ndarray,      # [K] bool
    path: str | Path | None = None,
) -> np.ndarray:
    """Returns the [H, W1+W2, 3] uint8 canvas; writes PNG when path given."""
    H = max(img1.shape[0], img2.shape[0])
    W1, W2 = img1.shape[1], img2.shape[1]
    canvas = np.zeros((H, W1 + W2, 3), np.uint8)
    canvas[: img1.shape[0], :W1] = (
        np.clip(img1, 0, 1)[..., None] * 255
    ).astype(np.uint8)
    canvas[: img2.shape[0], W1:] = (
        np.clip(img2, 0, 1)[..., None] * 255
    ).astype(np.uint8)

    def _line(c, x0, y0, x1, y1, color):
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
        xs = np.linspace(x0, x1, n).astype(int)
        ys = np.linspace(y0, y1, n).astype(int)
        ok = (xs >= 0) & (xs < c.shape[1]) & (ys >= 0) & (ys < c.shape[0])
        c[ys[ok], xs[ok]] = color

    rng = np.random.default_rng(0)
    for i in np.nonzero(np.asarray(valid))[0]:
        x0, y0 = float(uv1[i, 0]), float(uv1[i, 1])
        x1, y1 = float(uv2[i, 0]) + W1, float(uv2[i, 1])
        color = rng.integers(64, 255, 3)
        _line(canvas, x0, y0, x1, y1, color)
        for (x, y) in ((x0, y0), (x1, y1)):
            yy, xx = int(y), int(x)
            canvas[max(0, yy - 1):yy + 2, max(0, xx - 1):xx + 2] = color

    if path is not None:
        from PIL import Image

        Image.fromarray(canvas).save(path)
    return canvas
