"""Deep frontend: SuperPoint-class extractor, LightGlue-class matcher
(port of eacham_tpu/features/deep)."""

from eacham_tpu_torch.features.deep.superpoint import SuperPointNet, extract_deep  # noqa: F401
from eacham_tpu_torch.features.deep.lightglue import LightGlueMatcher, match_deep  # noqa: F401
