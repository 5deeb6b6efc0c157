"""Device kernels (copies and fills not counted) of the profiled request
per frame it registered."""


def read(ctx):
    tr, req = ctx["trace"], ctx.get("traced_request")
    if tr is None or req is None or not req["registered"]:
        return None
    return tr["kernels"] / req["registered"]
