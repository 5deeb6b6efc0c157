"""Bundle adjustment of the port (``core.refine_ba``)."""

from eacham_tpu_torch.ba.core import BAProblem, BAConfig, refine_ba, ba_cost  # noqa: F401
