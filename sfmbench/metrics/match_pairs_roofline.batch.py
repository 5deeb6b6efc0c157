"""Kernel 1's share (%) of its roofline in the profiled request: the least
time the card could take for the work its inputs need (sfmbench/roofline.py,
from the shapes and the real candidate pairs) over the device time of its
launches (``match_pairs_kernel`` in the trace), per launch."""

from sfmbench import roofline

ROW_TILE = 128          # the table is padded to whole row tiles of keypoints


def read(ctx):
    tr, req = ctx["trace"], ctx.get("traced_request")
    if tr is None or req is None:
        return None
    hits = [(t, n) for name, (t, n) in tr["by_name"].items() if "match_pairs_kernel" in name]
    launches = sum(n for _, n in hits)
    if not launches:
        return None
    seconds = sum(t for t, _ in hits) / launches
    scene = req["out"]["scene"]
    pairs = scene["pair_idx"]
    real = pairs[pairs[:, 0] < pairs[:, 1]]
    k = req["out"]["desc"].shape[1]
    kp = -(-k // ROW_TILE) * ROW_TILE
    frames = int(real.unique().numel())
    flops, nbytes = roofline.match_pairs_work(int(real.shape[0]), kp,
                                              req["out"]["desc"].shape[2], frames)
    return 100.0 * roofline.bound_seconds(flops, nbytes) / seconds
