"""Kernel 3's share (%) of its roofline in the profiled request: the least
time the card could take for the attention the matcher needs
(``roofline.masked_attention_work`` at the TF32 peak, which no
implementation at fp32 accuracy can pass) over the device time of every
``masked_attention_kernel`` launch in the trace.

The work is counted on the real pairs only (the bucket's and the chunk's
padding rows are computed all the same, and are not work): each pair's
``layers`` layers hold four blocks of ``HEADS`` heads whose queries are all
K keypoint slots and whose keys are the block's live keypoints: frame i's
for ``self0`` and ``cross1``, frame j's for ``self1`` and ``cross0``."""

from sfmbench import roofline

HEADS, HEAD_DIM = 4, 64


def work(pairs, mask, layers: int) -> tuple[float, float]:
    """(FLOP, bytes) of kernel 3 on the real rows of ``pairs`` [P, 2] (i < j)
    with keypoint masks ``mask`` [N, K]."""
    real = pairs[pairs[:, 0] < pairs[:, 1]].long()
    live = mask.bool().sum(1).double()
    keys = 2.0 * float(live[real[:, 0]].sum() + live[real[:, 1]].sum())   # per layer
    rows = 4 * layers * int(real.shape[0])
    if not rows:
        return 0.0, 0.0
    k = int(mask.shape[1])
    return roofline.masked_attention_work(rows, HEADS, k, layers * keys / rows, HEAD_DIM, nk=k)


def read(ctx):
    tr, req = ctx["trace"], ctx.get("traced_request")
    layers = (ctx["config"].get("frontend") or {}).get("n_layers")
    if tr is None or req is None or layers is None:
        return None
    seconds = sum(t for name, (t, _) in tr["by_name"].items()
                  if "masked_attention_kernel" in name)
    if seconds <= 0:
        return None
    flops, nbytes = work(req["out"]["scene"]["pair_idx"], req["out"]["mask"], layers)
    if not flops:
        return None
    return 100.0 * roofline.bound_seconds(flops, nbytes, roofline.PEAK_TF32_FLOPS) / seconds
