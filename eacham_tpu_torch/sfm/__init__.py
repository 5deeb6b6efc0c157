"""SfM state, match graph, two-view initialization and the pipeline
(port of eacham_tpu/sfm)."""
