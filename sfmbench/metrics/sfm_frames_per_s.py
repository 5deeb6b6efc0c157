"""All frames of all requests of the window over the window's length, from
its start to the end of its last request (host clock)."""


def read(ctx):
    if not ctx["requests"]:
        return None
    return sum(r["frames"] for r in ctx["requests"]) / ctx["window_s"]
