"""A copy of the benchmark's folder cut to a size the CPU runs in seconds,
for the tests: 12 frames at 256x192, K=256 (the tracks: 256 points), 11 of
them to register, a warm-up of 6 frames, streams of 12 frames in chunks
of 4."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def tiny_copy(dst: Path, rate: float = 50.0) -> Path:
    """The folder and BENCHMARK.json copied under ``dst`` and cut down;
    returns the copied folder."""
    shutil.copytree(HERE, dst / "sfmbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (dst / "sfmbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["inputs"]["frames"] = 12
        c["guarantees"]["min_registered"] = 11
        if c["inputs"]["kind"] == "orbit_blobs":
            c["inputs"].update(width=256, height=192, step_deg=1.5)
            c["frontend"]["max_keypoints"] = 256
            c["options"].update(min_initial_inliers=40, max_features=256, lm_capacity=4096)
        else:
            c["inputs"]["points"] = 256
            c["options"].update(min_initial_inliers=40, lm_capacity=4096)
        p.write_text(json.dumps(c))
    for name, extra in (("batch", {"warmup_frames": 6}),
                        ("stream", {"warmup_frames": 8, "chunk": 4, "stream_frames": 12,
                                    "rate_fps": rate, "finalize_every": 2})):
        p = dst / "sfmbench" / "traffic" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(extra)
        p.write_text(json.dumps(c))
    return dst / "sfmbench"
