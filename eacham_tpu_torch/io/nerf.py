"""transform.json -> transforms_nerf.json converter (port of
eacham_tpu/io/nerf.py).

Equivalent of the ``TransformToNerf`` binary (apps/sfm/TransformToNerf.cpp:
9-78): per frame, invert the stored world->cam matrix (giving cam->world)
and right-multiply diag(1, -1, -1, 1) — the OpenCV->NGP camera-axis flip
(cpp:52-57). All other fields pass through unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def convert_pose(world_to_cam: np.ndarray) -> np.ndarray:
    return np.linalg.inv(world_to_cam) @ _FLIP


def transform_to_nerf(folder: str | Path) -> Path:
    """Reads <folder>/transform.json, writes <folder>/transforms_nerf.json;
    returns the output path (same contract as the reference CLI)."""
    folder = Path(folder)
    src = folder / "transform.json"
    data = json.loads(src.read_text())
    for frame in data["frames"]:
        pose = np.asarray(frame["transform_matrix"], np.float64)
        frame["transform_matrix"] = convert_pose(pose).tolist()
    out = folder / "transforms_nerf.json"
    out.write_text(json.dumps(data, indent=4) + "\n")
    return out


def main(argv=None):
    """CLI matching the reference binary:
    ``python -m eacham_tpu_torch.io.nerf <folder with transform.json>``
    (TransformToNerf.cpp:11-16)."""
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 1:
        print("usage: python -m eacham_tpu_torch.io.nerf "
              "'folder with transform.json (result of eacham_tpu_torch sfm)'")
        return -1
    folder = Path(args[0])
    if not (folder / "transform.json").exists():
        print("Error: no 'transform.json' in the given folder")
        return -1
    out = transform_to_nerf(folder)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
