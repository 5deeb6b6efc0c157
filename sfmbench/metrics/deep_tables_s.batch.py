"""Mean over the window's requests not under the profiler of the harness's
synchronized span around the kind's match tables
(``build_match_tables_deep``: candidate pairs, the attentional matcher,
epipolar verification, the inverse tables)."""


def read(ctx):
    rs = [r for r in ctx["requests"] if not r["profiled"]] or ctx["requests"]
    xs = [r["tables_s"] for r in rs if r.get("tables_s") is not None]
    return sum(xs) / len(xs) if xs else None
