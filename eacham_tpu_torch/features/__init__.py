"""Classical frontend: DoG detector, 256-d descriptor, batched matching
(port of eacham_tpu/features).

Re-exports what the reference's package exports. ``match_pair`` runs the
batched matcher on one pair (one kernel launch on the card); the fp32
single-pair kernel is ``ops.match_pair_fused``."""

from eacham_tpu_torch.features.detector import detect_keypoints, build_scale_space  # noqa: F401
from eacham_tpu_torch.features.descriptor import describe_keypoints  # noqa: F401
from eacham_tpu_torch.features.matching import match_pair, match_all_pairs  # noqa: F401
from eacham_tpu_torch.features.frontend import extract_features, ClassicalFrontend  # noqa: F401
