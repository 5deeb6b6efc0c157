"""Geometry: SE(3), camera, RANSAC, triangulation, epipolar and homography
estimation (port of eacham_tpu/geometry)."""

from eacham_tpu_torch.geometry.se3 import (  # noqa: F401
    hat,
    exp_se3,
    log_se3,
    retract,
    inverse_se3,
    transform_points,
    camera_center,
)
from eacham_tpu_torch.geometry.camera import (  # noqa: F401
    make_intrinsics,
    intrinsics_from_image_size,
    project,
    project_hom,
    backproject,
    pixel_to_normalized,
    reprojection_error,
)
from eacham_tpu_torch.geometry.triangulation import (  # noqa: F401
    triangulate_dlt,
    triangulation_angle,
    is_positive_depth,
    triangulate_consensus,
)
