"""Classical frontend: DoG detector, 256-d descriptor, batched matching
(port of eacham_tpu/features)."""
