"""Multi-device runs over torch.distributed: one process per device (port
of eacham_tpu/parallel)."""

from eacham_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, init_distributed, make_mesh, make_mesh_2d, mesh_axes,
)
from eacham_tpu_torch.parallel.matching import match_all_pairs_sharded  # noqa: F401
from eacham_tpu_torch.parallel.ba import refine_ba_sharded  # noqa: F401
