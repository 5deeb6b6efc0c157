"""The deep front half's model FLOP as a share (%) of the card's TF32 peak
over a whole request: SuperPoint on every frame at the size the network is
handed (padded to whole 8x8 cells) and the attentional matcher on the real
candidate pairs (``roofline.superpoint_flops``,
``roofline.attention_matcher_flops``), over the mean request's ``total_s``
times ``roofline.PEAK_TF32_FLOPS``; the requests not under the profiler
(host clock)."""

from sfmbench import roofline


def model_flops(record: dict, height: int, width: int, layers: int) -> float:
    out = record["out"]
    pairs = out["scene"]["pair_idx"]
    real = int((pairs[:, 0] < pairs[:, 1]).sum())
    h, w = -(-height // 8) * 8, -(-width // 8) * 8
    return (roofline.superpoint_flops(record["frames"], h, w)
            + roofline.attention_matcher_flops(real, int(out["desc"].shape[1]), layers))


def read(ctx):
    layers = (ctx["config"].get("frontend") or {}).get("n_layers")
    rs = [r for r in ctx["requests"] if not r["profiled"]] or ctx["requests"]
    if layers is None or not rs:
        return None
    inp = ctx["config"]["inputs"]
    flops = sum(model_flops(r, inp["height"], inp["width"], layers) for r in rs) / len(rs)
    seconds = sum(r["total_s"] for r in rs) / len(rs)
    return 100.0 * flops / (seconds * roofline.PEAK_TF32_FLOPS)
