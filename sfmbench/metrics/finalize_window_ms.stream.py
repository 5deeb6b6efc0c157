"""Mean over the window's chunks not under the profiler whose stats hold a
global BA (every 5th) of the harness's synchronized span around ``process()``."""


def read(ctx):
    if not ctx["stream"]:
        return None
    xs = [c["span_s"] for c in ctx["stream"]["chunks"] if not c["profiled"] and c["global_ba"]]
    return 1e3 * sum(xs) / len(xs) if xs else None
