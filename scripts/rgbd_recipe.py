"""The RGB-D and stereo recipes of ``chip_smoke.py``'s ``rgbd`` and ``stereo``
phases, in numpy alone (it imports neither package), shared by the port's
smoke run and ``scripts/rgbd_reference_jax.py``:

* the world and the camera path: the bench's blob field, seed 0
  (``make_blob_scene(n_blobs=900, depth=(3.5, 9.0), spread=2.6)``) on the
  bench's orbit (``orbit_poses(100, radius=0.6, step_deg=0.5,
  advance=0.03)``); the caller makes both with its own package's
  ``utils/synthetic.py`` (the two copies draw the same arrays);
* TUM RGB-D's frame size and nominal intrinsics (640x480, fx = fy = 525,
  cx = 319.5, cy = 239.5), its 16-bit depth scaled by 5000, and its
  directory layout (``rgb/``, ``depth/``, ``rgb.txt``, ``depth.txt`` with
  the depth stamps 7 ms after the colour ones at 30 Hz, ``groundtruth.txt``
  as camera-to-world ``ts tx ty tz qx qy qz qw``);
* the depth renderer: each pixel takes the camera depth of the blob that
  contributes most to it in ``render_view``'s splat (0 where none does),
  then 1% seeded multiplicative noise;
* the rectified stereo rule: the right camera sits ``STEREO_BASELINE``
  along the left camera's x axis, so a point's disparity is f * B / z.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

N_FRAMES = 100
BLOBS = dict(n_blobs=900, depth=(3.5, 9.0), spread=2.6)
ORBIT = dict(radius=0.6, step_deg=0.5, advance=0.03)
TUM_SIZE = (640, 480)
TUM_INTR = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
TUM_DEPTH_FACTOR = 5000.0
TUM_RATE_HZ = 30.0
TUM_DEPTH_LAG_S = 0.007
TUM_T0 = 1305031102.175304      # a TUM-like epoch stamp
DEPTH_NOISE = 0.01
DEPTH_NOISE_SEED = 1
STEREO_BASELINE = 0.1           # meters along the left camera's x axis
PAINT_HALF = 14                 # render_view's splat window half-size


def render_depth(scene: dict, T: np.ndarray, intr, width: int, height: int) -> np.ndarray:
    """[H, W] float32 camera depth of the blob that contributes most to
    each pixel in ``render_view``'s additive splat (its amplitude times its
    Gaussian, over the same windows); 0 where no blob paints."""
    pts = scene["pts"]
    pc = pts @ np.asarray(T[:3, :3], np.float32).T + np.asarray(T[:3, 3], np.float32)
    fx, fy, cx, cy = (float(v) for v in np.asarray(intr))
    r = PAINT_HALF
    z = pc[:, 2]
    u = fx * pc[:, 0] / np.maximum(z, 0.2) + cx
    v = fy * pc[:, 1] / np.maximum(z, 0.2) + cy
    paint = np.nonzero((z > 0.2) & (u > -r) & (u < width + r) & (v > -r) & (v < height + r))[0]
    best = np.zeros((height, width), np.float32)
    depth = np.zeros((height, width), np.float32)
    span = np.arange(-r, r + 1, dtype=np.float32)
    for i in paint:
        ui, vi = np.float32(u[i]), np.float32(v[i])
        xs = int(ui) + span.astype(np.int32)
        ys = int(vi) + span.astype(np.int32)
        dx = (np.float32(int(ui)) + span) - ui
        dy = (np.float32(int(vi)) + span) - vi
        c, s = np.cos(scene["theta"][i]), np.sin(scene["theta"][i])
        rx = (c * dx[None, :] + s * dy[:, None]) / scene["sx"][i]
        ry = (-s * dx[None, :] + c * dy[:, None]) / scene["sy"][i]
        stamp = scene["amp"][i] * np.exp(-0.5 * (rx * rx + ry * ry))
        okx = (xs >= 0) & (xs < width)
        oky = (ys >= 0) & (ys < height)
        if not okx.any() or not oky.any():
            continue
        x0, x1 = xs[okx][0], xs[okx][-1] + 1
        y0, y1 = ys[oky][0], ys[oky][-1] + 1
        st = stamp[np.ix_(oky, okx)]
        win = best[y0:y1, x0:x1]
        take = st > win
        win[take] = st[take]
        depth[y0:y1, x0:x1][take] = z[i]
    return depth


def noisy_depth(depth: np.ndarray, frame: int, scale: float = DEPTH_NOISE) -> np.ndarray:
    """Frame ``frame``'s depth with seeded multiplicative noise
    (tests/test_rgbd.py's form); 0 stays 0."""
    rng = np.random.default_rng((DEPTH_NOISE_SEED, frame))
    return (depth * (1.0 + rng.normal(scale=scale, size=depth.shape))).astype(np.float32)


def right_pose(T_left: np.ndarray, baseline: float = STEREO_BASELINE) -> np.ndarray:
    """World->cam pose of the rectified right camera: the left camera moved
    ``baseline`` along its own x axis (x_right = x_left - baseline)."""
    S = np.eye(4, dtype=np.float32)
    S[0, 3] = -baseline
    return (S @ T_left).astype(np.float32)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[3, 3] rotation -> (qx, qy, qz, qw), qw >= 0."""
    m = R.astype(np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s, s / 4]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0, 0.0, 0.0, (m[k, j] - m[j, k]) / s]
        q[i] = s / 4
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
    q = np.asarray(q)
    return q if q[3] >= 0 else -q


def write_tum(root: Path, images: np.ndarray, depths: np.ndarray, poses_w2c: np.ndarray):
    """A TUM RGB-D directory: 8-bit ``rgb/*.png``, 16-bit ``depth/*.png``
    (meters x 5000), ``rgb.txt``, ``depth.txt`` (7 ms later) and
    ``groundtruth.txt`` (camera-to-world at the colour stamps)."""
    from PIL import Image

    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rgb, dep, gt = ["# color images"], ["# depth maps"], ["# timestamp tx ty tz qx qy qz qw"]
    for i, (img, d, T) in enumerate(zip(images, depths, poses_w2c)):
        t = TUM_T0 + i / TUM_RATE_HZ
        td = t + TUM_DEPTH_LAG_S
        Image.fromarray(np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)).save(
            root / "rgb" / f"{t:.6f}.png")
        d16 = np.clip(np.round(d * TUM_DEPTH_FACTOR), 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(root / "depth" / f"{td:.6f}.png")
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
        c2w = np.linalg.inv(np.asarray(T, np.float64))
        q = _rot_to_quat(c2w[:3, :3])
        gt.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*c2w[:3, 3], *q)))
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")


def metric_ate(est_w2c: np.ndarray, gt_w2c: np.ndarray, valid: np.ndarray) -> float:
    """RMSE of the ``valid`` frames' camera centres with ground truth
    expressed in frame 0's camera gauge (``T_gt[i] @ inv(T_gt[0])``): no
    scale and no rotation fitted. Poses [N, 4, 4] world->cam."""
    gt_w2c = np.asarray(gt_w2c, np.float64)
    gauge = (gt_w2c @ np.linalg.inv(gt_w2c[0]))[valid]
    est_w2c = np.asarray(est_w2c)[valid]
    est = np.asarray(est_w2c, np.float64)
    c_est = -np.einsum("nij,ni->nj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("nij,ni->nj", gauge[:, :3, :3], gauge[:, :3, 3])
    return float(np.sqrt(np.mean(np.sum((c_est - c_gt) ** 2, -1))))


def stereo_keep(xy_left, xy_right_matched, valid, max_dv: float = 1.0):
    """The stereo phases' match filter: valid, on the same row within
    ``max_dv`` px, positive disparity. Takes numpy arrays or tensors."""
    dv = abs(xy_left[..., 1] - xy_right_matched[..., 1])
    disp = xy_left[..., 0] - xy_right_matched[..., 0]
    return valid & (dv <= max_dv) & (disp > 0)
