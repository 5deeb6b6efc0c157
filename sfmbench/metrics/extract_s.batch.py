"""Mean over the window's requests not under the profiler of the harness's
synchronized span around ``extract_features``."""


def read(ctx):
    rs = [r for r in ctx["requests"] if not r["profiled"]] or ctx["requests"]
    xs = [r["extract_s"] for r in rs if r.get("extract_s") is not None]
    return sum(xs) / len(xs) if xs else None
