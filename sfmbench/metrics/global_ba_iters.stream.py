"""Mean LM iterations of the traced stream's global BAs (``ba.global``
spans: every 5th chunk's and ``finalize()``'s)."""

from sfmbench import spans


def read(ctx):
    return spans.mean_count(spans.stream(ctx), "ba.global", "iterations")
