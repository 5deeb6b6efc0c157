"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
importing nothing of the program (nor JAX).

- ``frontend``: the difference-of-Gaussians detector and the 256-d
  gradient-histogram descriptor, in float64, re-derived from the images.
- ``matcher``: mutual nearest neighbours with Lowe's ratio test on
  bf16-rounded descriptors, in float64.
- ``geometry``: similarity-aligned trajectory error, epipolar distances
  under the ground truth, and a block-wise Gauss-Newton refinement that
  tells how far a bundle-adjusted map lies from its optimum.
- ``frontends``: one module a frontend kind, the frontend's numbers and the
  reference matcher of that kind (``frontends/dog.py``: the two above).
- ``judge``: the numbers compared, from a request's inputs and outputs.
"""
