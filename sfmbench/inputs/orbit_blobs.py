"""The bench's orbit through a blob field, rendered on the host.

Frozen copies of ``make_blob_scene``, ``orbit_poses`` and ``render_view``
(eacham_tpu_torch/utils/synthetic.py, as ``bench_gpu.py`` and
``chip_smoke.py`` call them): a test holds them equal to the port's, array
for array. Only the blob field's generator seed comes from the run's seed.
"""

from __future__ import annotations

import numpy as np


def make_blob_scene(rng, n_blobs: int = 400, depth=(3.0, 8.0), spread=1.5,
                    textured: bool = False):
    """Random 3-D blob field with per-blob appearance parameters."""
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
        wav = rng.uniform(3.0, 9.0, n_blobs).astype(np.float32)
        ang = rng.uniform(0, np.pi, n_blobs).astype(np.float32)
        scene["tfx"] = (2 * np.pi / wav * np.cos(ang)).astype(np.float32)
        scene["tfy"] = (2 * np.pi / wav * np.sin(ang)).astype(np.float32)
        scene["tph"] = rng.uniform(0, 2 * np.pi, n_blobs).astype(np.float32)
        scene["tm"] = rng.uniform(0.5, 0.9, n_blobs).astype(np.float32)
    return scene


def render_view(scene: dict, T: np.ndarray, intr, width: int, height: int,
                background: np.ndarray | None = None):
    """One [H, W] grayscale view through the world->cam transform T:
    every blob in front of the camera paints a bounded window."""
    pts = scene["pts"]
    pc = pts @ np.asarray(T[:3, :3], np.float32).T + np.asarray(T[:3, 3], np.float32)
    fx, fy, cx, cy = (float(v) for v in np.asarray(intr))
    img = (np.zeros((height, width), np.float32) if background is None
           else background.astype(np.float32).copy())
    vis = pc[:, 2] > 0.2
    u = fx * pc[:, 0] / np.maximum(pc[:, 2], 0.2) + cx
    v = fy * pc[:, 1] / np.maximum(pc[:, 2], 0.2) + cy
    r = 14
    composite = "tfx" in scene
    paint = np.nonzero(
        vis & (u > -r) & (u < width + r) & (v > -r) & (v < height + r))[0]
    if composite:
        paint = paint[np.argsort(-pc[paint, 2])]
    if len(paint):
        P = len(paint)
        ui = u[paint].astype(np.float32)
        vi = v[paint].astype(np.float32)
        x0s = np.maximum(0, ui.astype(np.int32) - r)
        x1s = np.minimum(width, ui.astype(np.int32) + r + 1)
        y0s = np.maximum(0, vi.astype(np.int32) - r)
        y1s = np.minimum(height, vi.astype(np.int32) + r + 1)
        span = np.arange(-r, r + 1, dtype=np.float32)
        dx = (ui.astype(np.int32).astype(np.float32)[:, None]
              + span[None, :]) - ui[:, None]
        dy = (vi.astype(np.int32).astype(np.float32)[:, None]
              + span[None, :]) - vi[:, None]
        dxg = dx[:, None, :]
        dyg = dy[:, :, None]
        c = np.cos(scene["theta"][paint])[:, None, None]
        s = np.sin(scene["theta"][paint])[:, None, None]
        rx = (c * dxg + s * dyg) / scene["sx"][paint][:, None, None]
        ry = (-s * dxg + c * dyg) / scene["sy"][paint][:, None, None]
        gauss = np.exp(-0.5 * (rx * rx + ry * ry))
        amp = scene["amp"][paint][:, None, None]
        if composite:
            lx = c * dxg + s * dyg
            ly = -s * dxg + c * dyg
            m = scene["tm"][paint][:, None, None]
            tex = (1.0 + m * np.cos(
                scene["tfx"][paint][:, None, None] * lx
                + scene["tfy"][paint][:, None, None] * ly
                + scene["tph"][paint][:, None, None])) / (1.0 + m)
            colors = amp * tex
            alphas = np.minimum(3.0 * gauss, 1.0)
        else:
            stamps = amp * gauss
        for i in range(P):
            x0, x1, y0, y1 = int(x0s[i]), int(x1s[i]), int(y0s[i]), int(y1s[i])
            if x0 >= x1 or y0 >= y1:
                continue
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


def orbit_poses(n_frames: int, radius: float = 0.8, step_deg: float = 2.0,
                advance: float = 0.1):
    """Slowly orbiting and advancing camera path (world->cam matrices)."""
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


def make(params: dict, seed: int) -> dict:
    """``params``: frames, width, height, n_blobs, depth, spread, radius,
    step_deg, advance, f_scale. Returns images [N, H, W] float32 in [0, 1],
    poses [N, 4, 4] world->cam and intr [4]."""
    w, h, n = params["width"], params["height"], params["frames"]
    f = params["f_scale"] * max(w, h)
    intr = np.array([f, f, w / 2, h / 2], np.float32)
    scene = make_blob_scene(np.random.default_rng(seed), n_blobs=params["n_blobs"],
                            depth=tuple(params["depth"]), spread=params["spread"])
    poses = orbit_poses(n, radius=params["radius"], step_deg=params["step_deg"],
                        advance=params["advance"])
    images = np.stack([render_view(scene, T, intr, w, h) for T in poses])
    return {"images": images, "poses": poses, "intr": intr, "size": (w, h)}
