"""Share (%) of the traced request's ``run_sfm`` (``sfm.pipeline.run_sfm``)
spent in the initial pair's search and seeding (``sfm.pipeline.init_pair``)."""

from sfmbench import spans


def read(ctx):
    return spans.share(spans.batch(ctx), "sfm.pipeline.init_pair", "sfm.pipeline.run_sfm")
