"""Share (%) of the profiled stream's span (its frames' waits included) in
which no operation ran on the card."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["stream"] is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
