"""Mean over the window's chunks not under the profiler and without a global
BA of the harness's synchronized span around ``process()``."""


def read(ctx):
    if not ctx["stream"]:
        return None
    xs = [c["span_s"] for c in ctx["stream"]["chunks"]
          if not c["profiled"] and not c["global_ba"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
