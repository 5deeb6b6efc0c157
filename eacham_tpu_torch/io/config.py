"""JSON run-configuration, schema-compatible with the reference (port of
eacham_tpu/io/config.py).

Reads the same config files as ``SfmConfig::Parse``
(modules/sfm/config/SfmConfig.h:27-71; examples in config/SfmConfig.json,
SfmConfigNerf.json). Two knowing fixes over the reference parser
(SURVEY.md §5 "Config"):
  * ``global_ba.delta`` / ``use_preconditioner`` are read from the
    ``global_ba`` section (the reference reads them from ``refine_ba`` —
    SfmConfig.h:67-68), falling back to ``refine_ba`` when absent;
  * ``ui`` is parsed but, as in practice for the reference (flag never
    consulted, main.cpp always opens the window), only recorded.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from eacham_tpu_torch.sfm.pipeline import SfmOptions


@dataclass(frozen=True)
class OptimizerConfig:
    """Mirror of OptimizerConfig (SfmConfig.h:15-24)."""

    method: str = "LM"
    max_iter: int = 100
    max_tolerance: float = 1e-5
    delta: float = 10.0
    use_preconditioner: bool = False


@dataclass(frozen=True)
class SfmConfig:
    """Mirror of SfmConfig (SfmConfig.h:73-93)."""

    images_path: str = ""
    output_transform_path: str = ""
    max_data_size: int = 0
    ui: bool = False
    nerfy: bool = False
    min_features_count: int = 100
    max_features_count: int = 15000
    inliers_ratio: float = 0.8
    initial_min_inliers: int = 450
    initial_max_repr_error: float = 4.0
    initial_min_tri_angle: float = float(np.deg2rad(3.0))
    max_repr_error: float = 8.0
    min_tri_angle: float = float(np.deg2rad(2.0))
    min_pnp_inliers: int = 15
    refine_opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    global_opt: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(max_iter=150, max_tolerance=1e-7)
    )

    def to_options(self, max_keypoints: int = 1024, **overrides) -> SfmOptions:
        """Map the file schema onto the pipeline's SfmOptions."""
        kw = dict(
            max_features=max_keypoints,
            min_features_count=self.min_features_count,
            match_ratio=self.inliers_ratio,
            min_initial_inliers=self.initial_min_inliers,
            init_max_repr_error=self.initial_max_repr_error,
            init_min_tri_angle_deg=float(np.rad2deg(self.initial_min_tri_angle)),
            max_repr_error=self.max_repr_error,
            min_tri_angle_deg=float(np.rad2deg(self.min_tri_angle)),
            min_pnp_inliers=self.min_pnp_inliers,
            refine_max_iters=self.refine_opt.max_iter,
            refine_tolerance=self.refine_opt.max_tolerance,
            refine_method=self.refine_opt.method,
            refine_delta=self.refine_opt.delta,
            global_max_iters=self.global_opt.max_iter,
            global_tolerance=self.global_opt.max_tolerance,
            global_method=self.global_opt.method,
            global_delta=self.global_opt.delta,
            refine_solver="pcg" if self.refine_opt.use_preconditioner else "auto",
            global_solver="pcg" if self.global_opt.use_preconditioner else "auto",
        )
        kw.update(overrides)
        return SfmOptions(**kw)


def _opt(section: dict, fallback: dict) -> OptimizerConfig:
    return OptimizerConfig(
        method=section.get("method", "LM"),
        max_iter=int(section["max_iter"]),
        max_tolerance=float(section["max_toler"]),
        delta=float(section.get("delta", fallback.get("delta", 10.0))),
        use_preconditioner=bool(
            section.get(
                "use_preconditioner", fallback.get("use_preconditioner", False)
            )
        ),
    )


def parse_config(data: dict) -> SfmConfig:
    """Field-for-field port of SfmConfig::Parse (SfmConfig.h:27-71)."""
    root = data["root_path"]
    feature = data["feature"]
    recon = data["reconstruction"]
    initial = recon["initial_pair"]
    processing = recon["processing"]
    refine = data["refine_ba"]
    global_ = data["global_ba"]
    return SfmConfig(
        images_path=root + data["images_path"],
        output_transform_path=root + data["transform_path"],
        max_data_size=int(data["max_data_count"]),
        ui=data.get("ui") in (True, "true"),
        nerfy=bool(data.get("nerfy", False)),
        min_features_count=int(feature["min_features_count"]),
        max_features_count=int(feature["max_features_count"]),
        inliers_ratio=float(feature["inliers_ratio"]),
        initial_min_inliers=int(initial["min_inliers"]),
        initial_max_repr_error=float(initial["max_reprojection_error"]),
        initial_min_tri_angle=float(np.deg2rad(initial["min_angle"])),
        max_repr_error=float(processing["max_reprojection_error"]),
        min_tri_angle=float(np.deg2rad(processing["min_angle"])),
        min_pnp_inliers=int(processing["min_pnp_inliers"]),
        refine_opt=_opt(refine, refine),
        global_opt=_opt(global_, refine),
    )


def load_config(path: str | Path) -> SfmConfig:
    """The parser::Parse<SfmConfig> entry (ConfigParser.h:10-22)."""
    with open(path) as f:
        return parse_config(json.load(f))
