"""The port stands alone: no module of eacham_tpu_torch, and neither
chip_smoke.py nor bench_gpu.py, imports JAX or the JAX package, and its entry points never
carry on silently on the CPU when a card was asked for."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import eacham_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "eacham_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "eacham_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        eacham_tpu_torch.__path__, prefix="eacham_tpu_torch."))


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    """A ``None`` entry in ``sys.modules`` makes any import of that name
    raise, so a stray import of JAX or of eacham_tpu fails here."""
    mods = _modules()
    assert "eacham_tpu_torch.ops.match_kernel" in mods and len(mods) > 20
    assert {"eacham_tpu_torch.ops.attention", "eacham_tpu_torch.convert",
            "eacham_tpu_torch.features.deep.superpoint",
            "eacham_tpu_torch.features.deep.lightglue",
            "eacham_tpu_torch.features.deep.frontend",
            "eacham_tpu_torch.geometry.pnp", "eacham_tpu_torch.ba.core",
            "eacham_tpu_torch.sfm.triangulate", "eacham_tpu_torch.sfm.filtering",
            "eacham_tpu_torch.sfm.device_loop", "eacham_tpu_torch.sfm.pipeline",
            "eacham_tpu_torch.sfm.streaming", "eacham_tpu_torch.cli",
            "eacham_tpu_torch.utils.timer", "eacham_tpu_torch.io",
            *(f"eacham_tpu_torch.io.{m}" for m in (
                "native_loader", "images", "config", "saver", "nerf", "export",
                "checkpoint", "stream"))} <= set(mods)
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(ROOT)!r})",
        *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "import bench_gpu",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _sources():
    """The port's Python sources (not its build directory), chip_smoke.py,
    bench_gpu.py and the port's scripts."""
    files = [p for p in PKG.rglob("*.py") if "_build" not in p.parts]
    scripts = [p for p in (ROOT / "scripts").glob("*_torch.py")]
    return sorted(str(p.relative_to(ROOT))
                  for p in [*files, ROOT / "chip_smoke.py", ROOT / "bench_gpu.py", *scripts])


@pytest.mark.parametrize("path", _sources())
def test_no_source_names_jax(path):
    """Imports inside functions count too: the import check above only
    reaches module level."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_refuse_a_missing_card():
    """Without a card, asking for the card raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from eacham_tpu_torch.features.deep import frontend as deep
    from eacham_tpu_torch.features.deep.lightglue import LightGlueMatcher
    from eacham_tpu_torch.features.deep.superpoint import SuperPointNet
    from eacham_tpu_torch.features.frontend import extract_features
    from eacham_tpu_torch.sfm.pipeline import initialize_sfm, run_sfm

    images = np.zeros((1, 64, 64), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features(images, max_keypoints=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deep.load_frontend_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deep.extract_deep_batch(SuperPointNet(), images, max_keypoints=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deep.build_match_tables_deep(
            LightGlueMatcher(n_layers=1), np.zeros((2, 8, 2), np.float32),
            np.zeros((2, 8, 256), np.float32), np.ones((2, 8), bool), (64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deep.match_images_e2e(SuperPointNet(), LightGlueMatcher(n_layers=1),
                              np.zeros((2, 64, 64), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_sfm(np.zeros((2, 8, 2), np.float32), np.zeros((2, 8, 256), np.float32),
                       np.ones((2, 8), bool), (64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sfm(np.zeros((2, 8, 2), np.float32), np.zeros((2, 8, 256), np.float32),
                np.ones((2, 8), bool), (64, 64))
    from eacham_tpu_torch import convert
    from tests.test_torch_ba import make_problem
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.ba_problem_from_numpy(make_problem()[0])


def test_io_streaming_and_cli_entry_points_refuse_a_missing_card(tmp_path):
    """The entry points of the fifth slice raise as well: loading a scene
    checkpoint, resuming, streaming and the command line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from eacham_tpu_torch import cli
    from eacham_tpu_torch.io.checkpoint import load_scene, save_scene
    from eacham_tpu_torch.sfm.pipeline import resume_sfm, run_sfm
    from eacham_tpu_torch.sfm.streaming import StreamingReconstructor

    scene, _ = run_sfm(np.zeros((2, 8, 2), np.float32), np.zeros((2, 8, 256), np.float32),
                       np.ones((2, 8), bool), (64, 64), device="cpu")
    save_scene(tmp_path / "s.npz", scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_scene(tmp_path / "s.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resume_sfm(scene, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingReconstructor((64, 64), max_frames=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingReconstructor.restore(tmp_path / "s.npz", (64, 64))
    (tmp_path / "images").mkdir()
    (tmp_path / "images" / "a.pgm").write_bytes(b"P5\n2 2\n255\n" + bytes(4))
    cfg = json.loads((ROOT / "configs" / "SfmConfig.json").read_text())
    cfg["root_path"] = str(tmp_path)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(str(tmp_path / "cfg.json"), verbose=False)


def test_bench_gpu_fails_without_a_card():
    """The benchmark prints no result and exits non-zero where there is no
    card: it never measures the CPU under a device metric's name."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "bench_gpu.py")], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0 and "sfm_frames_per_s" not in out.stdout
    assert "no CUDA device" in out.stderr
