"""Geometry: SE(3), camera, RANSAC, triangulation, epipolar and homography
estimation, stereo and depth backprojection (port of eacham_tpu/geometry)."""

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
from eacham_tpu_torch.geometry.stereo import (  # noqa: F401
    point_from_stereo,
    point_from_depth,
    hamming_distance,
    match_hamming,
)
