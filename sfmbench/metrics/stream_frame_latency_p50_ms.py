"""Median over every frame of the window of the time from its due time to
the return of the call after which its pose was first valid (a frame never
registered counts at its stream's end)."""

import numpy as np


def read(ctx):
    if not ctx["stream"]:
        return None
    return 1e3 * float(np.percentile(ctx["stream"]["latencies"], 50))
