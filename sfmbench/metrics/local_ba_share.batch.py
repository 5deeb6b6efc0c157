"""Share (%) of the traced request's sweep (``sfm.device_loop``) spent in its
local BAs (``sfm.device_loop.local_ba``: the window build, ``refine_ba`` and
the scatters)."""

from sfmbench import spans


def read(ctx):
    return spans.share(spans.batch(ctx), "sfm.device_loop.local_ba", "sfm.device_loop")
