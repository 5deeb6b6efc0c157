"""numpy utilities: synthetic rendering, trajectory evaluation, stage
timers and match overlays; the profiler hooks."""

from eacham_tpu_torch.utils.evaluate import align_umeyama, ate_rmse  # noqa: F401
from eacham_tpu_torch.utils.timer import BlockTimer, print_stats  # noqa: F401
from eacham_tpu_torch.utils.profiling import device_trace, memory_summary  # noqa: F401
from eacham_tpu_torch.utils.viz import draw_matches  # noqa: F401
