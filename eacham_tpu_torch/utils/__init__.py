"""numpy utilities: synthetic rendering, trajectory evaluation and stage
timers."""

from eacham_tpu_torch.utils.evaluate import align_umeyama, ate_rmse  # noqa: F401
from eacham_tpu_torch.utils.timer import BlockTimer, print_stats  # noqa: F401
