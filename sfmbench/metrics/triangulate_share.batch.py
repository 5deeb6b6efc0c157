"""Share (%) of the traced request's sweep (``sfm.device_loop``) spent in
its two triangulation passes a registration (``sfm.device_loop.triangulate``)."""

from sfmbench import spans


def read(ctx):
    return spans.share(spans.batch(ctx), "sfm.device_loop.triangulate", "sfm.device_loop")
