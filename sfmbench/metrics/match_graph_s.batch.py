"""Mean over the window's requests not under the profiler of
``run_sfm``'s ``stats["seconds"]["match_graph"]`` (it synchronizes the card)."""


def read(ctx):
    rs = [r for r in ctx["requests"] if not r["profiled"]] or ctx["requests"]
    xs = [r["seconds"]["match_graph"] for r in rs if "match_graph" in r["seconds"]]
    return sum(xs) / len(xs) if xs else None
