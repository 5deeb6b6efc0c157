"""SfM state, match graph, two-view initialization, the pipeline, loop
closing, absolute anchors and metric RGB-D / stereo reconstruction (port of
eacham_tpu/sfm)."""

from eacham_tpu_torch.sfm.scene import Scene, make_scene, ba_problem_from_scene  # noqa: F401
from eacham_tpu_torch.sfm.matches import build_match_tables, observers_of_frame  # noqa: F401
from eacham_tpu_torch.sfm.twoview import recover_pose_two_view, find_best_pair  # noqa: F401
from eacham_tpu_torch.sfm.triangulate import triangulate_frame  # noqa: F401
from eacham_tpu_torch.sfm.pipeline import (  # noqa: F401
    run_sfm, resume_sfm, initialize_sfm, SfmOptions,
)
from eacham_tpu_torch.sfm.anchors import anchors_in_estimate_frame  # noqa: F401
from eacham_tpu_torch.sfm.rgbd import (  # noqa: F401
    run_sfm_rgbd, depth_at_keypoints, stereo_depth_at_keypoints,
)
