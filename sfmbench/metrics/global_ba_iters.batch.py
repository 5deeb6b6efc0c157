"""Mean LM iterations of the traced request's global BAs (the count
``iterations`` of its ``ba.global`` spans: one, or two when the second
prune changed the problem)."""

from sfmbench import spans


def read(ctx):
    return spans.mean_count(spans.batch(ctx), "ba.global", "iterations")
