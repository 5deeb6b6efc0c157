"""Share (%) of the profiled request's span in which no operation ran on the
card: 1 - the union of device busy intervals over the span."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx.get("traced_request") is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
