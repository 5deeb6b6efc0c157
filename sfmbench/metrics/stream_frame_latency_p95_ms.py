"""The 95th percentile of the same per-frame latency as the median's."""

import numpy as np


def read(ctx):
    if not ctx["stream"]:
        return None
    return 1e3 * float(np.percentile(ctx["stream"]["latencies"], 95))
