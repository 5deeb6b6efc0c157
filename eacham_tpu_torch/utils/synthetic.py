"""Synthetic scene rendering for tests and benchmarks.

The reference's interface layer admits a synthetic camera but never ships
one (SURVEY.md §4); this module is that missing piece: a 3-D field of
anisotropic Gaussian blobs rendered through pinhole cameras, giving image
sequences with exact ground-truth poses/structure for end-to-end pipeline
tests, ATE evaluation, and benchmarks.
"""

from __future__ import annotations

import numpy as np


def make_blob_scene(rng, n_blobs: int = 400, depth=(3.0, 8.0), spread=1.5,
                    textured: bool = False):
    """Random 3-D blob field with per-blob appearance parameters.

    ``textured`` stamps a random sinusoidal pattern (frequency, phase,
    orientation) onto each blob. Plain Gaussians are photometrically
    near-identical, so descriptors are ambiguous and matching collapses
    beyond tiny viewpoint changes (measured on the 500-frame orbit: at a
    10-frame offset only ~1-4 of the NN matches are epipolar-consistent
    with ground truth at ANY ratio). Real scenes have distinctive local
    texture; the modulation restores that property for wide-baseline
    workloads.
    """
    pts = rng.uniform(-spread, spread, (n_blobs, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(depth[0], depth[1], n_blobs)
    scene = {
        "pts": pts,
        "amp": rng.uniform(0.35, 1.0, n_blobs).astype(np.float32),
        "theta": rng.uniform(0, np.pi, n_blobs).astype(np.float32),
        "sx": rng.uniform(1.5, 4.0, n_blobs).astype(np.float32),
        "sy": rng.uniform(1.5, 4.0, n_blobs).astype(np.float32),
    }
    if textured:
        wav = rng.uniform(3.0, 9.0, n_blobs).astype(np.float32)  # px
        ang = rng.uniform(0, np.pi, n_blobs).astype(np.float32)
        scene["tfx"] = (2 * np.pi / wav * np.cos(ang)).astype(np.float32)
        scene["tfy"] = (2 * np.pi / wav * np.sin(ang)).astype(np.float32)
        scene["tph"] = rng.uniform(0, 2 * np.pi, n_blobs).astype(np.float32)
        scene["tm"] = rng.uniform(0.5, 0.9, n_blobs).astype(np.float32)
    return scene


def make_surface_scene(rng, n_blobs: int = 4000, center=(0.0, 0.0, 9.0),
                       radius: float = 5.0, jitter: float = 0.15):
    """Textured blobs sampled ON a (jittered) sphere — a surface world.

    A volumetric blob cloud cannot support wide-baseline matching at all:
    overlapping blobs at different depths shift tens of pixels relative to
    each other between nearby views (measured: descriptor cosine to the
    true counterpart drops to ~0.68 five frames apart on the 500-frame
    orbit), so every descriptor window is rearranged by parallax. Real
    scenes are piecewise-smooth SURFACES — neighboring structure sits at
    similar depth and local patches transform coherently. Sampling the
    blob field on a sphere restores that property while keeping exact
    ground truth and full 360-degree orbit coverage (there is always a
    facing hemisphere; the far side is occluded by the compositing order).
    """
    n = rng.normal(size=(n_blobs, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    r = radius * (1.0 + jitter * rng.uniform(-1, 1, (n_blobs, 1)))
    pts = (np.asarray(center, np.float32) + n * r).astype(np.float32)
    scene = {
        "pts": pts,
        "amp": rng.uniform(0.35, 1.0, n_blobs).astype(np.float32),
        "theta": rng.uniform(0, np.pi, n_blobs).astype(np.float32),
        "sx": rng.uniform(2.0, 5.0, n_blobs).astype(np.float32),
        "sy": rng.uniform(2.0, 5.0, n_blobs).astype(np.float32),
        # sphere center: lets GT-labeling code do hemisphere occlusion
        # (render_view ignores unknown keys)
        "center": np.asarray(center, np.float32),
    }
    wav = rng.uniform(3.0, 9.0, n_blobs).astype(np.float32)
    ang = rng.uniform(0, np.pi, n_blobs).astype(np.float32)
    scene["tfx"] = (2 * np.pi / wav * np.cos(ang)).astype(np.float32)
    scene["tfy"] = (2 * np.pi / wav * np.sin(ang)).astype(np.float32)
    scene["tph"] = rng.uniform(0, 2 * np.pi, n_blobs).astype(np.float32)
    scene["tm"] = rng.uniform(0.5, 0.9, n_blobs).astype(np.float32)
    return scene


def render_view(scene: dict, T: np.ndarray, intr, width: int, height: int,
                background: np.ndarray | None = None):
    """Render one [H, W] grayscale view through world->cam transform T.

    Vectorized splatting: each blob paints a bounded window. Blobs behind
    the camera are skipped (cheirality). ``background`` (e.g. from
    make_texture) is added under the blobs — view-independent photometric
    clutter for training data.
    """
    pts = scene["pts"]
    pc = pts @ np.asarray(T[:3, :3], np.float32).T + np.asarray(T[:3, 3], np.float32)
    fx, fy, cx, cy = (float(v) for v in np.asarray(intr))
    img = (np.zeros((height, width), np.float32) if background is None
           else background.astype(np.float32).copy())
    vis = pc[:, 2] > 0.2
    u = fx * pc[:, 0] / np.maximum(pc[:, 2], 0.2) + cx
    v = fy * pc[:, 1] / np.maximum(pc[:, 2], 0.2) + cy
    r = 14  # paint window half-size
    composite = "tfx" in scene
    paint = np.nonzero(
        vis & (u > -r) & (u < width + r) & (v > -r) & (v < height + r))[0]
    if composite:
        # textured scenes composite back-to-front with per-blob opacity:
        # additive splatting overdraws every pixel ~an order of magnitude,
        # so parallax between overlapping blobs scrambles local appearance
        # and wide-baseline matching is impossible no matter the
        # descriptor (measured). Occlusion is the property of real scenes
        # that keeps local appearance stable — "over" blending restores it.
        paint = paint[np.argsort(-pc[paint, 2])]
    # Patch math is BATCHED over all painted blobs (the per-blob Python
    # loop dominated surface-world training-data generation: 0.35 s/pair
    # at 1500 blobs); only the sequential composite ("over" blending is
    # order-dependent) remains a loop, over cheap slice writes. Values are
    # bit-identical to the per-blob formulation: each pixel's dx/dy depend
    # only on its absolute index minus the blob center, so computing the
    # full (2r+1)^2 window and slicing the clipped part changes nothing.
    if len(paint):
        P = len(paint)
        ui = u[paint].astype(np.float32)
        vi = v[paint].astype(np.float32)
        x0s = np.maximum(0, ui.astype(np.int32) - r)
        x1s = np.minimum(width, ui.astype(np.int32) + r + 1)
        y0s = np.maximum(0, vi.astype(np.int32) - r)
        y1s = np.minimum(height, vi.astype(np.int32) + r + 1)
        span = np.arange(-r, r + 1, dtype=np.float32)        # [2r+1]
        # window pixel x = int(u)+j for j in [-r, r]; dx = x - u
        dx = (ui.astype(np.int32).astype(np.float32)[:, None]
              + span[None, :]) - ui[:, None]                 # [P, 2r+1]
        dy = (vi.astype(np.int32).astype(np.float32)[:, None]
              + span[None, :]) - vi[:, None]
        dxg = dx[:, None, :]                                 # [P, 1, W]
        dyg = dy[:, :, None]                                 # [P, H, 1]
        c = np.cos(scene["theta"][paint])[:, None, None]
        s = np.sin(scene["theta"][paint])[:, None, None]
        rx = (c * dxg + s * dyg) / scene["sx"][paint][:, None, None]
        ry = (-s * dxg + c * dyg) / scene["sy"][paint][:, None, None]
        gauss = np.exp(-0.5 * (rx * rx + ry * ry))           # [P, H, W]
        amp = scene["amp"][paint][:, None, None]
        if composite:
            # per-blob sinusoidal stamp in blob-local pixel coordinates —
            # blobs are fixed-size sprites (footprint does not transform
            # with view), so a pixel-anchored pattern is view-consistent
            # by construction while making each blob visually unique
            lx = c * dxg + s * dyg
            ly = -s * dxg + c * dyg
            m = scene["tm"][paint][:, None, None]
            tex = (1.0 + m * np.cos(
                scene["tfx"][paint][:, None, None] * lx
                + scene["tfy"][paint][:, None, None] * ly
                + scene["tph"][paint][:, None, None])) / (1.0 + m)
            colors = amp * tex
            alphas = np.minimum(3.0 * gauss, 1.0)  # opaque core, soft edge
        else:
            stamps = amp * gauss
        for i in range(P):
            x0, x1, y0, y1 = int(x0s[i]), int(x1s[i]), int(y0s[i]), int(y1s[i])
            if x0 >= x1 or y0 >= y1:
                continue
            # patch-local slice of the clipped window
            px0 = x0 - (int(ui[i]) - r)
            py0 = y0 - (int(vi[i]) - r)
            px1 = px0 + (x1 - x0)
            py1 = py0 + (y1 - y0)
            if composite:
                alpha = alphas[i, py0:py1, px0:px1]
                sl = img[y0:y1, x0:x1]
                img[y0:y1, x0:x1] = (sl * (1.0 - alpha)
                                     + colors[i, py0:py1, px0:px1] * alpha)
            else:
                img[y0:y1, x0:x1] += stamps[i, py0:py1, px0:px1]
    return np.clip(img, 0.0, 1.0)


def make_texture(rng, height: int, width: int, cells: int = 8,
                 amplitude: float = 0.18):
    """Smooth low-frequency background texture (bilinear-upsampled random
    grid) — photometric structure that is NOT scene geometry, so detectors
    and descriptors trained on these renders must learn to cope with
    non-keypoint image content."""
    grid = rng.uniform(0.0, amplitude, (cells + 1, cells + 1)).astype(np.float32)
    ys = np.linspace(0, cells, height, dtype=np.float32)
    xs = np.linspace(0, cells, width, dtype=np.float32)
    y0 = np.clip(ys.astype(np.int32), 0, cells - 1)
    x0 = np.clip(xs.astype(np.int32), 0, cells - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    g = grid
    return ((1 - fy) * (1 - fx) * g[y0][:, x0]
            + (1 - fy) * fx * g[y0][:, x0 + 1]
            + fy * (1 - fx) * g[y0 + 1][:, x0]
            + fy * fx * g[y0 + 1][:, x0 + 1]).astype(np.float32)


def photometric_augment(img: np.ndarray, rng, brightness: float = 0.12,
                        contrast: float = 0.25, gamma: float = 0.25,
                        noise: float = 0.015) -> np.ndarray:
    """Per-view exposure/gamma/sensor-noise jitter (train-time augmentation
    closing part of the synthetic-to-real photometric gap)."""
    g = float(np.exp(rng.uniform(-gamma, gamma)))
    out = np.clip(img, 0.0, 1.0) ** g
    out = out * (1.0 + rng.uniform(-contrast, contrast))
    out = out + rng.uniform(-brightness, brightness)
    out = out + rng.normal(scale=noise, size=out.shape)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur (motion/defocus nuisance for robustness
    sweeps — scripts/robustness_matrix.py); dependency-free."""
    if sigma <= 0:
        return img
    r = max(1, int(3 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    # reflect-pad before convolving: zero padding would darken borders
    # (a vignetting artifact on top of the intended blur)
    pad = np.pad(img, r, mode="reflect")
    out = np.apply_along_axis(
        lambda row: np.convolve(row, k, mode="valid"), 1, pad)
    out = np.apply_along_axis(
        lambda col: np.convolve(col, k, mode="valid"), 0, out)
    return out.astype(np.float32)


def orbit_poses(n_frames: int, radius: float = 0.8, step_deg: float = 2.0,
                advance: float = 0.1):
    """Slowly orbiting/advancing camera path (world->cam matrices)."""
    poses = []
    for i in range(n_frames):
        a = np.deg2rad(step_deg * i)
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        t = np.array(
            [radius * np.sin(a) + advance * i * 0.3, 0.02 * i, 0.05 * i],
            np.float32,
        )
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses)


def stress_orbit_poses(n_frames: int, center=(0.0, 0.0, 9.0),
                       orbit_r: float = 14.0):
    """The long-trajectory stress orbit (stress_500 / anchor_probe /
    kitti_rehearsal SHARE this; they also share feature caches, so the
    geometry must come from one place): an inward look-at circle around
    the surface-world center, overshooting 360 deg so the tail revisits
    the start and retrieval closes the loop."""
    c = np.asarray(center, np.float32)
    poses = []
    for i in range(n_frames):
        a = np.deg2rad(360.0 * 1.04 * i / n_frames)
        cam = c + orbit_r * np.array(
            [np.sin(a), 0.025 * np.sin(5 * a), -np.cos(a)], np.float32)
        fwd = c - cam
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        R = np.stack([right, up, fwd]).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ cam
        poses.append(T)
    return np.stack(poses)


def render_sequence(rng, n_frames: int = 12, width: int = 320, height: int = 240,
                    n_blobs: int = 350, f_scale: float = 1.2):
    """Full synthetic dataset: (images [N,H,W], poses_gt [N,4,4], intr [4])."""
    f = f_scale * max(width, height)
    intr = np.array([f, f, width / 2, height / 2], np.float32)
    scene = make_blob_scene(rng, n_blobs=n_blobs)
    poses = orbit_poses(n_frames)
    images = np.stack([
        render_view(scene, T, intr, width, height) for T in poses
    ])
    return images, poses, intr
