"""Mean over the window's requests not under the profiler of
``run_sfm``'s ``stats["seconds"]["sweep"]`` (it synchronizes the card)."""


def read(ctx):
    rs = [r for r in ctx["requests"] if not r["profiled"]] or ctx["requests"]
    xs = [r["seconds"]["sweep"] for r in rs if "sweep" in r["seconds"]]
    return sum(xs) / len(xs) if xs else None
