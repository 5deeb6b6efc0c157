"""Share (%) of the traced request's sweep (the program's span
``sfm.device_loop``) spent in its PnP spans (``sfm.device_loop.pnp``:
``pnp_register`` and the read of its inlier count), host time on the
profiler's clock."""

from sfmbench import spans


def read(ctx):
    return spans.share(spans.batch(ctx), "sfm.device_loop.pnp", "sfm.device_loop")
