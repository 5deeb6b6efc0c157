"""Classical frontend: DoG detector, 256-d descriptor, batched matching
(port of eacham_tpu/features).

Re-exports what the reference's package exports and the port carries; its
``detect_keypoints``, ``describe_keypoints``, ``match_pair`` and
``ClassicalFrontend`` are not ported yet (ROADMAP queue 1, item 16; the
single-pair matcher is ``ops.match_pair_fused``)."""

from eacham_tpu_torch.features.detector import build_scale_space  # noqa: F401
from eacham_tpu_torch.features.matching import match_all_pairs  # noqa: F401
from eacham_tpu_torch.features.frontend import extract_features  # noqa: F401
