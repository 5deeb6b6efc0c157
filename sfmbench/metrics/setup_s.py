"""Seconds from the start of the process to the start of the window:
imports, the kernels' build or load, the inputs, the warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
