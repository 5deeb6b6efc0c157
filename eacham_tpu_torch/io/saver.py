"""Instant-NGP-style ``transform.json`` writer (port of
eacham_tpu/io/saver.py).

Field-for-field equivalent of ``SavePositions``
(modules/sfm/utils/Saver.h:13-73): version/w/h/cx/cy/fl_x/fl_y, zeroed
distortion (k1..k4, p1, p2, is_fisheye), camera_angle_x/y + fovx/fovy, and
``frames`` entries of {file_path, transform_matrix 4x4}. The matrix written
is the frame's stored world->cam transform, exactly as the reference writes
``node->GetTransform()`` (apps/sfm/main.cpp:243, Saver.h:56-62); the
camera-to-world + axis-flip conversion lives in the NeRF converter.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np


def positions_json(
    names: list[str],
    poses: np.ndarray,       # [M, 4, 4] world->cam, order matches names
    width: float,
    height: float,
    cx: float,
    cy: float,
    fx: float,
    fy: float,
) -> dict:
    angle_x = math.atan(width / (fx * 2.0)) * 2.0
    angle_y = math.atan(height / (fy * 2.0)) * 2.0
    out = {
        "version": 0,
        "w": width,
        "h": height,
        "cx": cx,
        "cy": cy,
        "fl_x": fx,
        "fl_y": fy,
        "k1": 0,
        "k2": 0,
        "k3": 0,
        "k4": 0,
        "p1": 0,
        "p2": 0,
        "is_fisheye": False,
        "camera_angle_x": angle_x,
        "camera_angle_y": angle_y,
        "fovx": angle_x * 180.0 / 3.141592,
        "fovy": angle_y * 180.0 / 3.141592,
        "frames": [
            {
                "file_path": name,
                "transform_matrix": np.asarray(pose, np.float64).tolist(),
            }
            for name, pose in zip(names, poses)
        ],
    }
    return out


def save_positions(
    path: str | Path,
    names: list[str],
    poses: np.ndarray,
    width: float, height: float,
    cx: float, cy: float, fx: float, fy: float,
) -> None:
    data = positions_json(names, poses, width, height, cx, cy, fx, fy)
    Path(path).write_text(json.dumps(data, indent=4) + "\n")
