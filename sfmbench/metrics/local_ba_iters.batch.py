"""Mean LM iterations a local BA of the traced request (the count
``iterations`` of each ``sfm.device_loop.local_ba`` span that ran one)."""

from sfmbench import spans


def read(ctx):
    return spans.mean_count(spans.batch(ctx), "sfm.device_loop.local_ba", "iterations")
