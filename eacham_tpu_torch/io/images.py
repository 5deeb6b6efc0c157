"""Host-side image loading: directory glob, grayscale, downsize policy
(port of eacham_tpu/io/images.py).

Equivalent of MonoImageReader + SfmInputSource
(modules/sfm/data_source/MonoImageReader.h:18-64, SfmInputSource.h:10-45):

  * globs ``*.jpg / *.JPG / *.png / *.PNG``, sorted (MonoImageReader.h:41-46)
  * honors ``max_data_count`` (0 = all, SfmInputSource.h:24-27)
  * the reference repeatedly resizes by x0.95 until rows <= 1500
    (SfmInputSource.h:28-33); here the same final scale ``0.95^n`` is
    applied in ONE deterministic resize

Decode runs on host threads; images stay numpy arrays on the host, and the
caller uploads the batch to the card once. Frames of unequal size are
zero-padded to the batch maximum with per-frame valid extents returned.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MAX_ROWS = 1500            # SfmInputSource.h:29
SCALE_STEP = 0.95          # SfmInputSource.h:31
# reference globs jpg/png only (MonoImageReader.h:41-46); also accept
# .jpeg plus the formats the native decoder handles (image_loader.cpp)
EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".pgm", ".bmp")


@dataclass
class ImageBatch:
    images: np.ndarray      # [N, H, W] float32 grayscale in [0, 1] (padded)
    sizes: np.ndarray       # [N, 2] int32 valid (width, height) per frame
    names: list[str]        # relative file names, load order
    color_images: np.ndarray | None = None   # [N, H, W, 3] optional
    # which decoder read the frames: "native", "pil", or "native+pil"
    # when the native loader left some files to PIL
    backend: str = ""

    @property
    def width(self) -> int:
        return int(self.images.shape[2])

    @property
    def height(self) -> int:
        return int(self.images.shape[1])


def downsize_policy(rows: int) -> float:
    """Final scale of the reference's repeated x0.95 loop, as one factor."""
    scale = 1.0
    r = float(rows)
    while r > MAX_ROWS:
        scale *= SCALE_STEP
        r = r * SCALE_STEP
    return scale


def list_images(directory: str | Path) -> list[Path]:
    d = Path(directory)
    files = [p for p in d.iterdir() if p.suffix.lower() in EXTENSIONS]
    return sorted(files)


def _load_native(files: list[Path], workers: int, strict: bool):
    """Batch decode through the native loader; None -> caller falls back to
    PIL wholesale (library unavailable)."""
    from eacham_tpu_torch.io import native_loader as nl

    if nl.get_lib() is None:
        if strict:
            raise RuntimeError("native loader requested but unavailable")
        return None
    dims = [nl.probe(f) for f in files]
    if any(d is None for d in dims):
        if strict:
            raise RuntimeError("native loader cannot decode all inputs")
        native_ok = [d is not None for d in dims]
    else:
        native_ok = [True] * len(files)
    # fallback decode (PIL) for unsupported files to learn their dims
    fallback = {}
    for i, ok in enumerate(native_ok):
        if not ok:
            fallback[i] = _decode_one(files[i], False)[0]
    H = max(
        [d[1] for d in dims if d is not None]
        + [g.shape[0] for g in fallback.values()]
    )
    W = max(
        [d[0] for d in dims if d is not None]
        + [g.shape[1] for g in fallback.values()]
    )
    out, sizes, status = nl.load_batch_native(files, H, W, workers=workers)
    for i, g in fallback.items():
        h, w = g.shape
        out[i, :h, :w] = g
        sizes[i] = (w, h)
    for i, f in enumerate(files):
        if status[i] != 0 and i not in fallback:
            g = _decode_one(f, False)[0]
            h, w = g.shape
            out[i, :h, :w] = g[:out.shape[1], :out.shape[2]]
            sizes[i] = (min(w, out.shape[2]), min(h, out.shape[1]))
            fallback[i] = g
    return ImageBatch(
        images=out, sizes=sizes, names=[f.name for f in files],
        color_images=None, backend="native+pil" if fallback else "native",
    )


def _decode_one(path: Path, keep_color: bool):
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        scale = downsize_policy(im.height)
        if scale != 1.0:
            im = im.resize(
                (max(1, round(im.width * scale)), max(1, round(im.height * scale))),
                Image.BILINEAR,
            )
        rgb = np.asarray(im, dtype=np.float32) / 255.0
    gray = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
    return gray, (rgb if keep_color else None)


def load_image_dir(
    directory: str | Path,
    max_count: int = 0,
    keep_color: bool = False,
    workers: int = 8,
    backend: str = "auto",     # "auto" | "native" | "pil"
) -> ImageBatch:
    """Load a dataset directory into one padded batch.

    ``backend="auto"`` uses the native C++ decoder pool
    (native/image_loader.cpp — PNG/PPM/PGM/BMP) and falls back to PIL per
    image for formats it reports unsupported (JPEG). ``ImageBatch.backend``
    says which decoder read the frames.
    """
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"backend is 'auto', 'native' or 'pil', not {backend!r}")
    files = list_images(directory)
    if max_count > 0:
        files = files[:max_count]
    if not files:
        raise FileNotFoundError(f"no {EXTENSIONS} images in {directory}")

    if backend in ("auto", "native") and not keep_color:
        result = _load_native(files, workers, strict=backend == "native")
        if result is not None:
            return result

    with ThreadPoolExecutor(max_workers=workers) as ex:
        decoded = list(ex.map(lambda p: _decode_one(p, keep_color), files))

    H = max(g.shape[0] for g, _ in decoded)
    W = max(g.shape[1] for g, _ in decoded)
    N = len(decoded)
    images = np.zeros((N, H, W), np.float32)
    sizes = np.zeros((N, 2), np.int32)
    colors = np.zeros((N, H, W, 3), np.float32) if keep_color else None
    for n, (g, c) in enumerate(decoded):
        h, w = g.shape
        images[n, :h, :w] = g
        sizes[n] = (w, h)
        if keep_color:
            colors[n, :h, :w] = c
    return ImageBatch(
        images=images, sizes=sizes,
        names=[f.name for f in files], color_images=colors, backend="pil",
    )
