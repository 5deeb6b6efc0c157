"""The port's examples run as a user runs them, on the CPU (``--device
cpu``), each as a subprocess on small inputs:
``examples/{extract_match,reconstruct_synthetic,stream_reconstruct}_torch.py``.

- ``extract_match_torch.py``: the classical frontend's match count within
  the single-pair matcher's agreement with the JAX package (decisions
  agree on more than 0.995 of the keypoints: at most 1 of 256 here) of the
  JAX example's on the same two frames; ``--frontend deep --weights
  weights`` loads the shipped 3-layer matcher and matches, where the JAX
  example, which builds a 6-layer tree whatever the weights hold, raises.
- ``reconstruct_synthetic_torch.py``: the demo's 12 frames registered, its
  ATE under 0.1 and its three files written.
- ``stream_reconstruct_torch.py``: 8 frames of a camera sliding past a
  smooth textured surface in windows of 4 at 1024 keypoints, with
  ``SfmOptions``' defaults (450 initial inliers at 3 deg), as the JAX
  example: every frame in ``transform.json``, and a checkpoint the JAX
  package's ``load_scene`` reads.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
ENV = {"JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "OMP_NUM_THREADS": "2"}
KPS = 256


def _run(argv, cwd, timeout=300):
    r = subprocess.run([sys.executable, *map(str, argv)], capture_output=True, text=True,
                       timeout=timeout, env=ENV, cwd=cwd)
    return r


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """12 frames of the demo's blob-field sequence (320x240) as PNGs."""
    from eacham_tpu_torch.utils.synthetic import render_sequence

    d = tmp_path_factory.mktemp("frames")
    images, _, _ = render_sequence(np.random.default_rng(0), n_frames=12, width=320,
                                   height=240, n_blobs=350)
    for i, img in enumerate(images):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(d / f"f{i:02d}.png")
    return d


def _count(text, frontend):
    m = re.search(rf"^{frontend}: (\d+) matches$", text, re.M)
    assert m, text
    return int(m.group(1))


def test_extract_match_classical_agrees_with_the_reference(frames, tmp_path):
    a, b = frames / "f00.png", frames / "f01.png"
    port = _run([ROOT / "examples" / "extract_match_torch.py", a, b, tmp_path / "port.png",
                 "--max-keypoints", KPS, "--device", "cpu"], tmp_path)
    assert port.returncode == 0, port.stderr[-2000:]
    assert (tmp_path / "port.png").exists()
    ref = _run([ROOT / "examples" / "extract_match.py", a, b, tmp_path / "ref.png",
                "--max-keypoints", KPS], tmp_path)
    assert ref.returncode == 0, ref.stderr[-2000:]
    n_port, n_ref = _count(port.stdout, "classical"), _count(ref.stdout, "classical")
    assert n_ref > 50 and abs(n_port - n_ref) <= 0.005 * KPS, (n_port, n_ref)
    assert Image.open(tmp_path / "port.png").size == Image.open(tmp_path / "ref.png").size


def test_extract_match_deep_loads_the_shipped_matcher(frames, tmp_path):
    a, b = frames / "f00.png", frames / "f01.png"
    port = _run([ROOT / "examples" / "extract_match_torch.py", a, b, tmp_path / "deep.png",
                 "--frontend", "deep", "--weights", "weights", "--max-keypoints", KPS,
                 "--device", "cpu"], ROOT)
    assert port.returncode == 0, port.stderr[-2000:]
    assert _count(port.stdout, "deep") > 20 and (tmp_path / "deep.png").exists()
    ref = _run([ROOT / "examples" / "extract_match.py", a, b, tmp_path / "ref.png",
                "--frontend", "deep", "--weights", "weights", "--max-keypoints", KPS], ROOT)
    assert ref.returncode != 0 and "KeyError" in ref.stderr, ref.stderr[-2000:]


def test_reconstruct_synthetic(tmp_path):
    r = _run([ROOT / "examples" / "reconstruct_synthetic_torch.py", tmp_path / "demo",
              "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "12/12 frames registered" in r.stdout
    ate = float(re.search(r"^ATE RMSE: (\S+)", r.stdout, re.M).group(1))
    assert ate < 0.1, r.stdout[-2000:]
    for name in ("transform.json", "cloud.ply", "trajectory.ply"):
        assert (tmp_path / "demo" / name).exists(), name
    assert len(json.loads((tmp_path / "demo" / "transform.json").read_text())["frames"]) == 12


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """8 frames of a camera sliding sideways past a smooth textured surface
    (``chip_smoke.slide_frames``' world, 512x384) as PNGs: parallax enough
    for the defaults' 3 deg."""
    from eacham_tpu_torch.utils.synthetic import make_surface_scene, orbit_poses, render_view

    d = tmp_path_factory.mktemp("slide")
    f = 1.2 * 512
    intr = np.array([f, f, 256, 192], np.float32)
    blobs = make_surface_scene(np.random.default_rng(0), n_blobs=2500, jitter=0.0)
    for i, T in enumerate(orbit_poses(8, radius=0.0, step_deg=0.0, advance=1.0)):
        img = render_view(blobs, T, intr, 512, 384)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(d / f"f{i:02d}.png")
    return d


def test_stream_reconstruct(slide, tmp_path):
    import jax.numpy as jnp

    from eacham_tpu.io.checkpoint import load_scene

    r = _run([ROOT / "examples" / "stream_reconstruct_torch.py", slide, "--window", "4",
              "--max-keypoints", 1024, "--device", "cpu",
              "--checkpoint", tmp_path / "state.npz", "--out", tmp_path / "transform.json"],
             tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.count("[stream] +4 frames") == 2
    assert "saved" in r.stdout and "(8/8 frames)" in r.stdout, r.stdout[-2000:]
    data = json.loads((tmp_path / "transform.json").read_text())
    assert len(data["frames"]) == 8
    scene, extra = load_scene(tmp_path / "state.npz")
    assert int(extra["n_frames"]) == 8 and bool(extra["initialized"])
    assert int(jnp.sum(scene.pose_valid)) == 8
    assert list(extra["names"]) == [f"f{i:02d}.png" for i in range(8)]
