"""The port stands alone: no module of eacham_tpu_torch, and neither
chip_smoke.py, bench_gpu.py, the port's scripts nor its examples, imports JAX or the JAX
package, and its entry points never carry on silently on the CPU when a card was asked
for."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eacham_tpu")


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
            "eacham_tpu_torch.features.deep.train",
            "eacham_tpu_torch.geometry.pnp", "eacham_tpu_torch.ba.core",
            "eacham_tpu_torch.sfm.triangulate", "eacham_tpu_torch.sfm.filtering",
            "eacham_tpu_torch.sfm.device_loop", "eacham_tpu_torch.sfm.pipeline",
            "eacham_tpu_torch.sfm.streaming", "eacham_tpu_torch.cli",
            "eacham_tpu_torch.utils.timer", "eacham_tpu_torch.io",
            "eacham_tpu_torch.sfm.posegraph", "eacham_tpu_torch.sfm.submap",
            "eacham_tpu_torch.sfm.anchors", "eacham_tpu_torch.sfm.rgbd",
            "eacham_tpu_torch.geometry.stereo", "eacham_tpu_torch.utils.profiling",
            "eacham_tpu_torch.utils.viz",
            *(f"eacham_tpu_torch.parallel.{m}" for m in ("mesh", "matching", "ba")),
            *(f"eacham_tpu_torch.io.{m}" for m in (
                "native_loader", "images", "config", "saver", "nerf", "export",
                "checkpoint", "stream", "datasets"))} <= set(mods)
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(ROOT)!r})",
        *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "import bench_gpu",
        # the public surface, as the reference's package exports it
        "import eacham_tpu_torch as e",
        "from eacham_tpu_torch.sfm import (run_sfm, resume_sfm, SfmOptions, Scene, make_scene,",
        "    ba_problem_from_scene, build_match_tables, observers_of_frame,",
        "    recover_pose_two_view, find_best_pair, triangulate_frame, anchors_in_estimate_frame,",
        "    run_sfm_rgbd, depth_at_keypoints, stereo_depth_at_keypoints)",
        "from eacham_tpu_torch.geometry import (hat, exp_se3, log_se3, retract, inverse_se3,",
        "    transform_points, camera_center, make_intrinsics, intrinsics_from_image_size,",
        "    project, project_hom, backproject, pixel_to_normalized, reprojection_error,",
        "    triangulate_dlt, triangulation_angle, is_positive_depth, triangulate_consensus,",
        "    point_from_stereo, point_from_depth, hamming_distance, match_hamming)",
        "from eacham_tpu_torch.ba import BAProblem, BAConfig, refine_ba, ba_cost",
        "from eacham_tpu_torch.utils import (align_umeyama, ate_rmse, BlockTimer, print_stats,",
        "    device_trace, memory_summary, draw_matches)",
        "from eacham_tpu_torch.features import (build_scale_space, match_all_pairs,",
        "    extract_features, detect_keypoints, describe_keypoints, match_pair,",
        "    ClassicalFrontend)",
        "from eacham_tpu_torch.io import TumDataset, KittiDataset, load_tum_groundtruth",
        "from eacham_tpu_torch.parallel import (init_distributed, make_mesh, make_mesh_2d,",
        "    mesh_axes, match_all_pairs_sharded, refine_ba_sharded)",
        "from eacham_tpu_torch.features.deep import (SuperPointNet, extract_deep,",
        "    LightGlueMatcher, match_deep)",
        "assert e.run_sfm is run_sfm and e.resume_sfm is resume_sfm and e.SfmOptions is SfmOptions",
        "from eacham_tpu_torch.io.config import SfmConfig, load_config",
        "assert e.SfmConfig is SfmConfig and e.load_config is load_config",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _sources():
    """The port's Python sources (not its build directory), chip_smoke.py,
    bench_gpu.py, the port's scripts and its examples."""
    files = [p for p in PKG.rglob("*.py") if "_build" not in p.parts]
    scripts = [*(ROOT / "scripts").glob("*_torch.py"), *(ROOT / "examples").glob("*_torch.py")]
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


@pytest.mark.parametrize("argv, result", [
    (["scripts/bench_deep_torch.py"], "deep_sfm_frames_per_s"),
    (["scripts/deep_sfm_replay_torch.py", "tables.npz"], '"package"'),
    (["examples/extract_end2end_torch.py", "a.png", "b.png"], "e2e:"),
], ids=["bench_deep_torch", "deep_sfm_replay_torch", "extract_end2end_torch"])
def test_deep_scripts_fail_without_a_card(argv, result):
    """The deep benchmark, the port's replay script and the end-to-end
    example print no result and exit non-zero where there is no card
    (unless the caller asks for the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / argv[0]), *argv[1:]], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0 and result not in out.stdout
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("argv, result", [
    (["scripts/anchor_probe_torch.py", "--frames", "60"], "anchor_error"),
    (["scripts/stress_100_torch.py"], "repeat_equal"),
], ids=["anchor_probe_torch", "stress_100_torch"])
def test_long_trajectory_and_stress_scripts_fail_without_a_card(argv, result):
    """The ports of scripts/anchor_probe.py and scripts/stress_100.py print
    no result and exit non-zero where there is no card (unless the caller
    asks for the CPU with ``--device cpu``)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / argv[0]), *argv[1:]], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0 and result not in out.stdout
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("argv, result", [
    (["scripts/robustness_matrix_torch.py", "--frames", "6", "--worlds", "1"], '"cells"'),
    (["scripts/tune_deep_recall_torch.py"], "before:"),
    (["examples/extract_match_torch.py", "a.png", "b.png"], "matches"),
    (["examples/reconstruct_synthetic_torch.py"], "ATE RMSE"),
    (["examples/stream_reconstruct_torch.py", "tests/data"], "saved"),
    (["scripts/robustness_split_torch.py", "--seeds", "1"], '"rows"'),
], ids=["robustness_matrix_torch", "tune_deep_recall_torch", "extract_match_torch",
        "reconstruct_synthetic_torch", "stream_reconstruct_torch", "robustness_split_torch"])
def test_matrix_recall_scripts_and_examples_fail_without_a_card(argv, result, tmp_path):
    """The ports of scripts/robustness_matrix.py and
    scripts/tune_deep_recall.py, the seed split and the three examples print no result and
    exit non-zero where there is no card (unless the caller asks for the
    CPU with ``--device cpu``); they write nothing into the working
    directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / argv[0]),
                          *(str(ROOT / a) if a.startswith("tests/") else a for a in argv[1:])],
                         capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0 and result not in out.stdout
    assert "no CUDA device" in out.stderr
    assert not any(tmp_path.iterdir())


def test_rgbd_datasets_frontend_and_parallel_entry_points_refuse_a_missing_card(tmp_path):
    """The seventh slice's entry points raise as well: the metric pipeline
    and its depth sampling, the TUM path past its host-side reader (the
    readers return numpy batches, as ``load_image_dir`` does; the first step
    on the card refuses), the per-image frontend, and the process group and
    mesh of a sharded run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from eacham_tpu_torch import features, parallel
    from eacham_tpu_torch.io.datasets import TumDataset
    from eacham_tpu_torch.sfm import rgbd

    ds = TumDataset.open(ROOT / "tests" / "data" / "tum_mini")
    batch = ds.load(max_count=2)
    assert batch.images.shape == (2, 192, 256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.extract_features(batch.images, max_keypoints=8)
    depth = np.zeros((2, 192, 256), np.float32)
    xy = np.zeros((2, 8, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rgbd.depth_at_keypoints(depth, xy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rgbd.stereo_depth_at_keypoints(xy, np.zeros((2, 8), np.float32),
                                       np.ones(4, np.float32), 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rgbd.run_sfm_rgbd(xy, np.zeros((2, 8, 256), np.float32), np.ones((2, 8), bool),
                          np.ones((2, 8), np.float32), np.ones(4, np.float32), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.detect_keypoints(batch.images[0], max_keypoints=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.describe_keypoints(batch.images[0], xy[0], np.zeros(8, np.int32),
                                    np.ones(8, bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.ClassicalFrontend(max_keypoints=8)(batch.images)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed(f"file://{tmp_path / 'store'}", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
