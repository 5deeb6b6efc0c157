"""The port stands alone: no module of eacham_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package, and its entry points never
carry on silently on the CPU when a card was asked for."""

import ast
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
            "eacham_tpu_torch.features.deep.frontend"} <= set(mods)
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(ROOT)!r})",
        *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _sources():
    """The port's Python sources (not its build directory) and chip_smoke.py."""
    files = [p for p in PKG.rglob("*.py") if "_build" not in p.parts]
    return sorted(str(p.relative_to(ROOT)) for p in [*files, ROOT / "chip_smoke.py"])


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
    from eacham_tpu_torch.sfm.pipeline import initialize_sfm

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
