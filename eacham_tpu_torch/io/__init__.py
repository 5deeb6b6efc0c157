"""Host-side input and output (port of eacham_tpu/io): config, images,
transform.json, the NeRF converter, scene checkpoints, PLY export, frame
streams and the TUM / KITTI dataset readers."""

from eacham_tpu_torch.io.config import SfmConfig, parse_config, load_config  # noqa: F401
from eacham_tpu_torch.io.images import load_image_dir, downsize_policy  # noqa: F401
from eacham_tpu_torch.io.saver import save_positions  # noqa: F401
from eacham_tpu_torch.io.nerf import transform_to_nerf  # noqa: F401
from eacham_tpu_torch.io.checkpoint import save_scene, load_scene  # noqa: F401
from eacham_tpu_torch.io.export import (  # noqa: F401
    export_cloud, export_trajectory, landmark_colors,
)
from eacham_tpu_torch.io.stream import ReplaySource, drain  # noqa: F401
from eacham_tpu_torch.io.datasets import (  # noqa: F401
    GroundTruth, KittiDataset, TumDataset, load_tum_groundtruth,
)
