"""Dataset readers: TUM RGB-D and KITTI odometry (port of
eacham_tpu/io/datasets.py).

Sources yield the same padded ``ImageBatch`` the pipeline consumes, plus
optional ground-truth trajectories for ATE evaluation. All parsing is on
the host; the caller uploads a sequence to the card as one batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from eacham_tpu_torch.io.images import ImageBatch


@dataclass
class GroundTruth:
    """Timestamped camera-to-world poses."""

    timestamps: np.ndarray   # [M]
    poses: np.ndarray        # [M, 4, 4] cam->world

    def associate(self, query_ts: np.ndarray, max_dt: float = 0.02):
        """Nearest-timestamp association; returns ([Q, 4, 4], valid [Q])."""
        idx = np.searchsorted(self.timestamps, query_ts)
        idx = np.clip(idx, 1, len(self.timestamps) - 1)
        left = self.timestamps[idx - 1]
        right = self.timestamps[idx]
        pick = np.where(query_ts - left < right - query_ts, idx - 1, idx)
        dt = np.abs(self.timestamps[pick] - query_ts)
        return self.poses[pick], dt <= max_dt


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[..., 4] (qx, qy, qz, qw) -> [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _index_lines(path: Path):
    """(timestamps, relative files) of a TUM index file (rgb.txt, depth.txt)."""
    ts, files = [], []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t, rel = line.split()[:2]
        ts.append(float(t))
        files.append(rel)
    return np.asarray(ts), files


# --------------------------------------------------------------------- TUM --

def load_tum_groundtruth(path: str | Path) -> GroundTruth:
    """Parse TUM groundtruth.txt: `ts tx ty tz qx qy qz qw` lines."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        if len(vals) >= 8:
            rows.append(vals[:8])
    data = np.asarray(rows)
    poses = np.tile(np.eye(4), (len(data), 1, 1))
    poses[:, :3, :3] = _quat_to_rot(data[:, 4:8])
    poses[:, :3, 3] = data[:, 1:4]
    return GroundTruth(timestamps=data[:, 0], poses=poses)


@dataclass
class TumDataset:
    """TUM RGB-D sequence (rgb.txt index, optional depth.txt and
    groundtruth.txt)."""

    root: Path
    timestamps: np.ndarray
    files: list[str]
    groundtruth: GroundTruth | None

    # TUM depth registration: 16-bit PNGs scaled by 5000 (meters = pixel /
    # 5000), indexed by depth.txt
    DEPTH_SCALE = 1.0 / 5000.0

    @classmethod
    def open(cls, root: str | Path) -> "TumDataset":
        root = Path(root)
        ts, files = _index_lines(root / "rgb.txt")
        gt_file = root / "groundtruth.txt"
        gt = load_tum_groundtruth(gt_file) if gt_file.exists() else None
        return cls(root=root, timestamps=ts, files=files, groundtruth=gt)

    def load(self, max_count: int = 0, workers: int = 8) -> ImageBatch:
        files = self.files[:max_count] if max_count > 0 else self.files
        return _load_listed(self.root, files, workers)

    def gt_for_frames(self, n: int | None = None):
        """(poses [n, 4, 4] cam->world, valid [n]) associated to the frames,
        or (None, None) without ground truth."""
        if self.groundtruth is None:
            return None, None
        ts = self.timestamps if n is None else self.timestamps[:n]
        return self.groundtruth.associate(ts)

    def load_depth(self, max_count: int = 0, max_dt: float = 0.02):
        """Depth maps associated to the rgb frames by nearest timestamp.

        Returns ``(depth [N, H, W] float32 meters, has_depth [N] bool)``;
        frames with no depth within ``max_dt`` get all-zero maps (0 is
        missing depth to ``sfm.rgbd``). Without depth.txt: (None, all False).
        """
        from PIL import Image

        ts_rgb = self.timestamps[:max_count] if max_count > 0 else self.timestamps
        idx_file = self.root / "depth.txt"
        if not idx_file.exists():
            return None, np.zeros(len(ts_rgb), bool)
        dts, dfiles = _index_lines(idx_file)
        maps = []
        for t in ts_rgb:
            j = int(np.argmin(np.abs(dts - t))) if len(dts) else -1
            if j < 0 or abs(dts[j] - t) > max_dt:
                maps.append(None)
                continue
            arr = np.asarray(Image.open(self.root / dfiles[j]))
            maps.append(arr.astype(np.float32) * self.DEPTH_SCALE)
        H = max((m.shape[0] for m in maps if m is not None), default=1)
        W = max((m.shape[1] for m in maps if m is not None), default=1)
        out = np.zeros((len(ts_rgb), H, W), np.float32)
        for i, m in enumerate(maps):
            if m is not None:
                out[i, :m.shape[0], :m.shape[1]] = m
        return out, np.asarray([m is not None for m in maps], bool)


# ------------------------------------------------------------------- KITTI --

@dataclass
class KittiDataset:
    """KITTI odometry sequence (image_0 grayscale, calib.txt, optional poses)."""

    root: Path
    files: list[str]
    intr: np.ndarray | None                 # [4] fx fy cx cy from calib P0
    groundtruth_poses: np.ndarray | None    # [M, 4, 4] cam->world

    @classmethod
    def open(cls, root: str | Path, poses_file: str | Path | None = None):
        root = Path(root)
        files = sorted(p.name for p in (root / "image_0").iterdir() if p.suffix == ".png")
        intr = None
        calib = root / "calib.txt"
        if calib.exists():
            for line in calib.read_text().splitlines():
                if line.startswith("P0:"):
                    P = np.asarray([float(v) for v in line.split()[1:]]).reshape(3, 4)
                    intr = np.array([P[0, 0], P[1, 1], P[0, 2], P[1, 2]], np.float32)
        gt = None
        if poses_file is not None and Path(poses_file).exists():
            rows = np.loadtxt(poses_file).reshape(-1, 3, 4)
            gt = np.tile(np.eye(4), (len(rows), 1, 1))
            gt[:, :3, :] = rows
        return cls(root=root, files=files, intr=intr, groundtruth_poses=gt)

    def load(self, max_count: int = 0, workers: int = 8) -> ImageBatch:
        files = self.files[:max_count] if max_count > 0 else self.files
        return _load_listed(self.root / "image_0", files, workers)


# ----------------------------------------------------------------- helpers --

def _load_listed(base: Path, rel_files: list[str], workers: int) -> ImageBatch:
    """Load an explicit ordered file list with the directory loader's
    decoders: the native one when it reads every file, else PIL."""
    from concurrent.futures import ThreadPoolExecutor

    from eacham_tpu_torch.io import native_loader as nl
    from eacham_tpu_torch.io.images import _decode_one

    paths = [base / f for f in rel_files]
    names = [str(f) for f in rel_files]
    dims = [nl.probe(p) for p in paths] if nl.get_lib() is not None else [None]
    if all(d is not None for d in dims):
        H = max(d[1] for d in dims)
        W = max(d[0] for d in dims)
        out, sizes, status = nl.load_batch_native(paths, H, W, workers=workers)
        if not status.any():
            return ImageBatch(images=out, sizes=sizes, names=names, backend="native")
    with ThreadPoolExecutor(max_workers=workers) as ex:
        decoded = list(ex.map(lambda p: _decode_one(p, False)[0], paths))
    H = max(g.shape[0] for g in decoded)
    W = max(g.shape[1] for g in decoded)
    images = np.zeros((len(decoded), H, W), np.float32)
    sizes = np.zeros((len(decoded), 2), np.int32)
    for i, g in enumerate(decoded):
        images[i, :g.shape[0], :g.shape[1]] = g
        sizes[i] = (g.shape[1], g.shape[0])
    return ImageBatch(images=images, sizes=sizes, names=names, backend="pil")
