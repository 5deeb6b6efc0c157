"""Geometry: SE(3), camera, RANSAC, triangulation, epipolar and homography
estimation (port of eacham_tpu/geometry)."""
