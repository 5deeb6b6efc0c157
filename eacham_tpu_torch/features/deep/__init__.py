"""Deep frontend: SuperPoint-class extractor, LightGlue-class matcher
(port of eacham_tpu/features/deep)."""
