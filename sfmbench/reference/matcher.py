"""Plain descriptor matching of frame pairs: for each keypoint of frame i
its nearest neighbour in frame j by the dot product of L2-normalised
descriptors, kept when Lowe's ratio test on the distances sqrt(2 - 2 s)
holds in both directions and the two keypoints are each other's nearest.

``rounding`` says to what the descriptors are rounded before the products
(which are then exact in float64): "bf16" is what the configuration states
for the matcher, "fp8" (e4m3) the control one precision below. ``ratio``
None drops the ratio test (the control that breaks the matching rule).
"""

from __future__ import annotations

import torch

DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn, "none": None}


def rounded(desc: torch.Tensor, rounding: str) -> torch.Tensor:
    dt = DTYPES[rounding]
    d = desc.to(torch.float32)
    if dt is not None:
        d = d.to(dt).to(torch.float32)
    return d.to(torch.float64)


def _ratio_ok(best, second, ratio):
    if ratio is None:
        return torch.ones_like(best, dtype=torch.bool)
    db = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    ds = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=0.0))
    return db < ratio * ds


@torch.no_grad()
def match_pairs(desc: torch.Tensor, mask: torch.Tensor, pairs: torch.Tensor, ratio,
                rounding: str = "bf16", chunk: int = 32):
    """desc [N, K, D], mask [N, K] bool, pairs [P, 2] (i, j). Returns
    (match_j [P, K] int64, valid [P, K] bool)."""
    d = rounded(desc, rounding)
    live = mask.bool()
    out_j, out_v = [], []
    for s in range(0, pairs.shape[0], chunk):
        p = pairs[s:s + chunk].long()
        a, b = d[p[:, 0]], d[p[:, 1]]
        la, lb = live[p[:, 0]], live[p[:, 1]]
        sim = a @ b.transpose(1, 2)
        sim = sim.masked_fill(~(la[:, :, None] & lb[:, None, :]), -torch.inf)
        top2r = sim.topk(2, dim=2)
        top2c = sim.topk(2, dim=1)
        best_j = top2r.indices[..., 0]
        ok_r = _ratio_ok(top2r.values[..., 0], top2r.values[..., 1], ratio) \
            & torch.isfinite(top2r.values[..., 0]) & la
        ok_c = _ratio_ok(top2c.values[:, 0], top2c.values[:, 1], ratio) \
            & torch.isfinite(top2c.values[:, 0]) & lb
        back = torch.gather(top2c.indices[:, 0], 1, best_j)
        k = torch.arange(a.shape[1], device=a.device)
        valid = ok_r & (back == k[None]) & torch.gather(ok_c, 1, best_j)
        out_j.append(best_j)
        out_v.append(valid)
    if not out_j:
        e = torch.zeros((0, desc.shape[1]), dtype=torch.long, device=desc.device)
        return e, e.bool()
    return torch.cat(out_j), torch.cat(out_v)


def reference_matches(out: dict, pairs: torch.Tensor, spec: dict, control=None):
    """The reference of ``run_sfm``'s own matching rule (kernel 1's) on the
    program's descriptors (``out["desc"]``, the map's keypoint mask) and on
    its real pairs [P, 2]: (match_j, valid, substitute). ``substitute`` is
    the control's (match_j, valid) in the program's place, ``control``
    "fp8" (fp8 descriptors) or "no_ratio" (no ratio test), and None
    otherwise."""
    desc, mask, ratio = out["desc"], out["scene"]["kp_mask"], spec["match_ratio"]
    rj, rv = match_pairs(desc, mask, pairs, ratio, "bf16")
    substitute = None
    if control == "fp8":
        substitute = match_pairs(desc, mask, pairs, ratio, "fp8")
    elif control == "no_ratio":
        substitute = match_pairs(desc, mask, pairs, None, "bf16")
    return rj, rv, substitute
