"""SuperPoint and the attentional matcher, written plainly in float64 from the
papers (SuperPoint: DeTone, Malisiewicz and Rabinovich, arXiv:1712.07629;
LightGlue: Lindenberger, Sarlin and Pollefeys, arXiv:2306.13643) and the
rules the configuration states, on the repository's weights, read from
``weights/*.npz`` by this module's own key map.

SuperPoint: a VGG encoder (3x3 convolutions 64-64 | 64-64 | 128-128 |
128-128 with ReLU, a 2x2 max pool between stages), a detector head (3x3 to
256, ReLU, 1x1 to 65: a softmax over 64 cell positions and a dustbin, the
64 unpacked to full resolution row-major within each 8x8 cell) and a
descriptor head (3x3 to 256, ReLU, 1x1 to 256, L2-normalised, eps 1e-8).
Extraction: zero-pad to multiples of 8; keep a heatmap value that is the
maximum of its 9x9 window (else 0); the K largest, ties to the lower
flat index; live where the score reaches 0.05. Each keypoint moves by the
heat-weighted centroid of its raw 3x3 neighbourhood (the soft position),
which is rounded half to even; there a 2-D quadratic fit of the image
blurred at sigma 1 (zero-padded separable taps of radius 3, float32-rounded
as the program keeps them) gives the final position where the fit is a
peak inside the cell (offset clamped to 0.6 px); elsewhere the soft
position stands. Descriptors are sampled bilinearly at the soft position
(in field cells, clamped to [0, size - 1.001]) and L2-normalised.

The matcher: keypoints centred and scaled by half the larger side of the
stated ``normalize_size``; a shared input projection of the descriptors;
per layer, self-attention on each side with rotary angles (each
coordinate times 2^0 .. 2^15, 32 angles, rotating the two halves of each
64-wide head), then cross-attention both ways from the layer's self
outputs. Each block: LayerNorm (eps 1e-6) of both inputs, 4 heads of 64,
softmax over the live keys only (a row without one gives zeros), an output
projection, then x + MLP(LayerNorm([LN(x), message])) with a 512-wide
tanh-GELU hidden layer. The assignment: final projections' products over
16, plus ``desc_sim_gain`` times the descriptors' cosine, -1e9 where either
side is masked; the two softmaxes multiplied together and by both sides'
sigmoid matchabilities. A keypoint of frame i matches its row's argmax
(first on ties) where that is mutual, its score is above the threshold and
the keypoint is live.

``judge_frontend``'s control "tf32" runs the SuperPoint forward and the
refinement's blur in float32 with every convolution's operands rounded to
TF32 first; ``reference_matches``' control "bf16" runs the matcher in bf16,
and "tf32" in float32 with both operands of every product rounded to TF32;
either is judged in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sfmbench.harness import HERE
from sfmbench.reference.frontend import gauss_taps, round_tf32
from sfmbench.reference.judge import compare_features

WEIGHTS = HERE.parent / "weights"
CELL = 8
SCORE_THRESHOLD = 0.05
NMS_RADIUS = 4
REFINE_SIGMA = 1.0
HEADS, HEAD_DIM = 4, 64
N_FREQ = HEAD_DIM // 4
LN_EPS = 1e-6
MASKED_SIM = -1e9
SP_CONVS = ("c1a", "c1b", "c2a", "c2b", "c3a", "c3b", "c4a", "c4b",
            "det1", "det2", "desc1", "desc2")
BLOCKS = ("self0", "self1", "cross0", "cross1")
DENSE = ("q", "k", "v", "proj", "mlp1", "mlp2")
NORMS = ("ln_x", "ln_y", "ln_m")
OUTER = ("in_proj", "final0", "final1", "match0", "match1")


# ---- the weights, by this module's own key map ---------------------------------------

def _key(*names: str) -> str:
    return "/".join(f"['{n}']" for n in ("params", *names))


class _Flat:
    """The arrays of one ``.npz`` in float64, each taken at most once; ``done``
    refuses arrays left over."""

    def __init__(self, path):
        with np.load(path) as data:
            self.arrays = {k: torch.from_numpy(np.asarray(data[k], np.float64))
                           for k in data.files}
        self.used = set()

    def take(self, *names: str) -> torch.Tensor:
        key = _key(*names)
        if key not in self.arrays:
            raise KeyError(f"the weights lack {key}")
        self.used.add(key)
        return self.arrays[key]

    def done(self, what: str) -> None:
        extra = sorted(set(self.arrays) - self.used)
        if extra:
            raise ValueError(f"{what}: {len(extra)} arrays have no place, e.g. {extra[0]}")


def superpoint_params(path=WEIGHTS / "superpoint.npz") -> dict:
    """{conv: (weight [out, in, kh, kw], bias [out])}, float64 on the CPU. The
    file keeps [kh, kw, in, out] kernels under ``backbone`` for the encoder."""
    flat = _Flat(path)
    out = {}
    for name in SP_CONVS:
        where = ("backbone", name) if name[0] == "c" else (name,)
        out[name] = (flat.take(*where, "kernel").permute(3, 2, 0, 1).contiguous(),
                     flat.take(*where, "bias"))
    flat.done("superpoint")
    return out


def matcher_params(n_layers: int, path=WEIGHTS / "lightglue.npz") -> dict:
    """{"<block>_<layer>": {dense: (weight [out, in], bias), norm: (scale,
    bias)}, outer dense: (weight, bias), "desc_sim_gain": []}, float64 on
    the CPU. The file keeps [in, out] kernels; every array must find its
    place, so a file of another depth is refused."""
    flat = _Flat(path)

    def dense(*where):
        return flat.take(*where, "kernel").t().contiguous(), flat.take(*where, "bias")

    out = {}
    for i in range(n_layers):
        for b in BLOCKS:
            name = f"{b}_{i}"
            out[name] = {d: dense(name, d) for d in DENSE}
            out[name].update({n: (flat.take(name, n, "scale"), flat.take(name, n, "bias"))
                              for n in NORMS})
    out.update({name: dense(name) for name in OUTER})
    out["desc_sim_gain"] = flat.take("desc_sim_gain")
    flat.done("lightglue")
    return out


def _cast(tree, dtype, device):
    if torch.is_tensor(tree):
        return tree.to(device=device, dtype=dtype)
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    return tuple(_cast(v, dtype, device) for v in tree)


def _loaded(what: str, dtype, device, n_layers: int = 0):
    """The shipped weights of ``what`` ("superpoint" or "matcher") in ``dtype``
    on ``device``, read anew each call."""
    raw = superpoint_params() if what == "superpoint" else matcher_params(n_layers)
    return _cast(raw, dtype, device)


# ---- SuperPoint ----------------------------------------------------------------------

class Convs:
    """float64 convolutions, or (``tf32``) float32 ones whose operands are
    rounded to TF32 first, as a card does with TF32 on."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64

    def __call__(self, x, w, b=None, padding=0):
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv2d(x, w, b, padding=padding)


def superpoint_forward(p: dict, images: torch.Tensor, conv: Convs):
    """images [B, H, W] (H, W multiples of 8) -> (heatmap [B, H, W],
    descriptor field [B, H/8, W/8, 256])."""
    x = images[:, None]
    for stage in ("c1", "c2", "c3", "c4"):
        x = F.relu(conv(x, *p[stage + "a"], padding=1))
        x = F.relu(conv(x, *p[stage + "b"], padding=1))
        if stage != "c4":
            x = F.max_pool2d(x, 2, 2)
    det = conv(F.relu(conv(x, *p["det1"], padding=1)), *p["det2"])
    prob = torch.softmax(det, dim=1)[:, :-1]
    B, _, h, w = prob.shape
    heat = prob.reshape(B, CELL, CELL, h, w).permute(0, 3, 1, 4, 2).reshape(B, h * CELL, w * CELL)
    desc = conv(F.relu(conv(x, *p["desc1"], padding=1)), *p["desc2"]).permute(0, 2, 3, 1)
    return heat, desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)


def _soft_offset(heat, xi, yi):
    """Heat-weighted centroid offset of each keypoint's 3x3 neighbourhood
    (indices clamped to the image)."""
    B, H, W = heat.shape
    d = torch.arange(-1, 2, device=heat.device)
    ys = (yi[:, :, None, None] + d[None, None, :, None]).clamp(0, H - 1)
    xs = (xi[:, :, None, None] + d[None, None, None, :]).clamp(0, W - 1)
    b = torch.arange(B, device=heat.device)[:, None, None, None]
    w = heat[b, ys, xs]
    total = w.sum(dim=(2, 3)).clamp(min=1e-12)
    df = d.to(heat.dtype)
    return torch.stack([(w.sum(2) * df).sum(-1) / total, (w.sum(3) * df).sum(-1) / total], -1)


def _blur(images, conv: Convs):
    taps = torch.as_tensor(gauss_taps(REFINE_SIGMA).astype(np.float32), device=images.device)
    taps = taps.to(images.dtype)
    r = (taps.numel() - 1) // 2
    x = conv(images[:, None], taps.view(1, 1, -1, 1), padding=(r, 0))
    return conv(x, taps.view(1, 1, 1, -1), padding=(0, r))[:, 0]


def _quadratic_offset(images, xi, yi, conv: Convs):
    """The 2-D quadratic fit of the blurred image around integer positions:
    (offset [B, K, 2] clamped to 0.6 px, ok where it is a peak in the cell)."""
    B, H, W = images.shape
    blur = _blur(images, conv)
    b = torch.arange(B, device=images.device)[:, None]

    def v(dy, dx):
        return blur[b, (yi + dy).clamp(0, H - 1), (xi + dx).clamp(0, W - 1)]

    c = v(0, 0)
    gx, gy = 0.5 * (v(0, 1) - v(0, -1)), 0.5 * (v(1, 0) - v(-1, 0))
    hxx, hyy = v(0, 1) + v(0, -1) - 2 * c, v(1, 0) + v(-1, 0) - 2 * c
    hxy = 0.25 * (v(1, 1) - v(1, -1) - v(-1, 1) + v(-1, -1))
    det = hxx * hyy - hxy * hxy
    fit = det.abs() > 1e-12
    ds = torch.where(fit, det, 1.0)
    ox = -(hyy * gx - hxy * gy) / ds
    oy = -(hxx * gy - hxy * gx) / ds
    ok = fit & (ox.abs() < 1.0) & (oy.abs() < 1.0) & (hxx < 0) & (hyy < 0)
    return torch.stack([ox.clamp(-0.6, 0.6), oy.clamp(-0.6, 0.6)], -1), ok


def _sample(field, x, y):
    """Bilinear samples of field [B, h, w, C] at [B, K] cell coordinates."""
    B, h, w, _ = field.shape
    x = x.clamp(0.0, w - 1.001)
    y = y.clamp(0.0, h - 1.001)
    x0, y0 = x.floor().long(), y.floor().long()
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    b = torch.arange(B, device=field.device)[:, None]
    return (field[b, y0, x0] * (1 - fx) * (1 - fy) + field[b, y0, x0 + 1] * fx * (1 - fy)
            + field[b, y0 + 1, x0] * (1 - fx) * fy + field[b, y0 + 1, x0 + 1] * fx * fy)


@torch.no_grad()
def extract(p: dict, images: torch.Tensor, max_keypoints: int, conv: Convs | None = None,
            score_threshold: float = SCORE_THRESHOLD):
    """Keypoints [B, K, 2], descriptors [B, K, 256] and live masks [B, K] of
    images [B, H, W] in [0, 1], by the rules of this module's docstring."""
    conv = conv or Convs()
    B, H, W = images.shape
    H8, W8 = -(-H // CELL) * CELL, -(-W // CELL) * CELL
    imgs = images.new_zeros((B, H8, W8), dtype=conv.dtype)
    imgs[:, :H, :W] = images
    heat_raw, field = superpoint_forward(p, imgs, conv)
    pooled = F.max_pool2d(heat_raw[:, None], 2 * NMS_RADIUS + 1, stride=1,
                          padding=NMS_RADIUS)[:, 0]
    heat = torch.where(heat_raw >= pooled, heat_raw, 0.0)
    score, idx = torch.sort(heat.reshape(B, -1), dim=-1, descending=True, stable=True)
    score, idx = score[:, :max_keypoints], idx[:, :max_keypoints]
    yi, xi = idx // W8, idx % W8
    live = score >= score_threshold
    soft = torch.stack([xi, yi], -1).to(conv.dtype) + _soft_offset(heat_raw, xi, yi)
    rounded = torch.round(soft)
    off, ok = _quadratic_offset(imgs, rounded[..., 0].long(), rounded[..., 1].long(), conv)
    xy = torch.where(ok[..., None], rounded + off, soft)
    desc = _sample(field, soft[..., 0] / CELL, soft[..., 1] / CELL)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
    return xy, desc, live


def judge_frontend(images, out, frames, fe, control=None):
    """Keypoints and descriptors of ``frames`` against the float64 SuperPoint
    (``judge.compare_features``); control "tf32": the same forward and blur
    with TF32 convolutions, judged in the program's place."""
    size = [int(images.shape[2]), int(images.shape[1])]
    if list(fe["normalize_size"]) != size:
        raise ValueError(f"frontend.normalize_size {fe['normalize_size']} is not the "
                         f"images' size {size}")
    imgs = images[frames]
    ref = _loaded("superpoint", torch.float64, imgs.device)
    rxy, rdesc, rlive = extract(ref, imgs.double(), fe["max_keypoints"])
    if control == "tf32":
        p32 = _loaded("superpoint", torch.float32, imgs.device)
        xy, desc, mask = extract(p32, imgs.float(), fe["max_keypoints"], Convs(tf32=True))
    else:
        xy, desc, mask = out["xy"][frames], out["desc"][frames], out["mask"][frames]
    return compare_features(xy, desc, mask, rxy, rdesc, rlive)


# ---- the matcher ---------------------------------------------------------------------

def normalize_keypoints(uv, width: float, height: float):
    size = torch.tensor([width, height], dtype=uv.dtype, device=uv.device)
    return (uv - size / 2) / (max(width, height) / 2)


def rotary_angles(coords):
    freqs = 2.0 ** torch.arange(N_FREQ, dtype=coords.dtype, device=coords.device)
    ang = coords[..., None, :] * freqs[:, None]
    return ang.reshape(*coords.shape[:-1], 2 * N_FREQ)


def _rotate(x, ang):
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _same(x):
    return x


def _linear(x, wb, rnd):
    """``F.linear`` with both operands of the product passed through ``rnd``."""
    return F.linear(rnd(x), rnd(wb[0]), wb[1])


def _attend(q, k, v, live, rnd=_same):
    """Softmax attention over the live keys; a row without one gives zeros."""
    s = torch.einsum("bhqd,bhkd->bhqk", rnd(q), rnd(k)) / HEAD_DIM ** 0.5
    dead = ~live[:, None, None, :]
    p = torch.softmax(s.masked_fill_(dead, -1e30), dim=-1).masked_fill_(dead, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", rnd(p), rnd(v))


def _block(p, x, y, live_y, ang_x=None, ang_y=None, rnd=_same):
    B, N, D = x.shape
    xn = F.layer_norm(x, (D,), *p["ln_x"], eps=LN_EPS)
    yn = F.layer_norm(y, (D,), *p["ln_y"], eps=LN_EPS)

    def heads(t, n):
        return t.reshape(B, n, HEADS, HEAD_DIM).transpose(1, 2)

    q = heads(_linear(xn, p["q"], rnd), N)
    k = heads(_linear(yn, p["k"], rnd), y.shape[1])
    v = heads(_linear(yn, p["v"], rnd), y.shape[1])
    if ang_x is not None:
        q, k = _rotate(q, ang_x), _rotate(k, ang_y)
    o = _linear(_attend(q, k, v, live_y, rnd).transpose(1, 2).reshape(B, N, D), p["proj"], rnd)
    m = F.layer_norm(torch.cat([xn, o], -1), (2 * D,), *p["ln_m"], eps=LN_EPS)
    h = F.gelu(_linear(m, p["mlp1"], rnd), approximate="tanh")
    return x + _linear(h, p["mlp2"], rnd)


def assignment(p: dict, n_layers: int, kps0, desc0, live0, kps1, desc1, live1, rnd=_same):
    """Assignment scores [B, N0, N1] of normalised keypoints and descriptors
    of both sides, in the dtype of ``p``; ``rnd`` takes both operands of
    every product (the identity, or a rounding to a narrower precision)."""
    x0, x1 = _linear(desc0, p["in_proj"], rnd), _linear(desc1, p["in_proj"], rnd)
    ang0, ang1 = rotary_angles(kps0), rotary_angles(kps1)
    for i in range(n_layers):
        x0 = _block(p[f"self0_{i}"], x0, x0, live0, ang0, ang0, rnd)
        x1 = _block(p[f"self1_{i}"], x1, x1, live1, ang1, ang1, rnd)
        x0, x1 = (_block(p[f"cross0_{i}"], x0, x1, live1, rnd=rnd),
                  _block(p[f"cross1_{i}"], x1, x0, live0, rnd=rnd))
    f0, f1 = _linear(x0, p["final0"], rnd), _linear(x1, p["final1"], rnd)
    m0 = torch.sigmoid(_linear(x0, p["match0"], rnd))[..., 0]
    m1 = torch.sigmoid(_linear(x1, p["match1"], rnd))[..., 0]
    d0 = desc0 / (torch.linalg.vector_norm(desc0, dim=-1, keepdim=True) + 1e-8)
    d1 = desc1 / (torch.linalg.vector_norm(desc1, dim=-1, keepdim=True) + 1e-8)
    sim = (rnd(f0) @ rnd(f1).transpose(1, 2) / f0.shape[-1] ** 0.5
           + p["desc_sim_gain"] * (rnd(d0) @ rnd(d1).transpose(1, 2)))
    both = live0[:, :, None] & live1[:, None, :]
    sim = torch.where(both, sim, MASKED_SIM)
    scores = torch.softmax(sim, 2) * torch.softmax(sim, 1) * m0[:, :, None] * m1[:, None, :]
    return torch.where(both, scores, 0.0)


def mutual_matches(scores, live0, threshold: float):
    """(match_j [B, N0], valid [B, N0]): each row's argmax where mutual, above
    ``threshold`` and live."""
    best0, best1 = scores.argmax(2), scores.argmax(1)
    s = torch.gather(scores, 2, best0[..., None])[..., 0]
    k = torch.arange(scores.shape[1], device=scores.device)
    return best0, (torch.gather(best1, 1, best0) == k) & (s > threshold) & live0


@torch.no_grad()
def match_pairs(out: dict, pairs, fe: dict, chunk: int, dtype=torch.float64, rnd=_same):
    """The matcher's matches on the program's keypoints, descriptors and masks
    (``out``) over ``pairs`` [P, 2], ``chunk`` pairs at a time, in ``dtype``,
    with ``rnd`` on the operands of every product (see ``assignment``)."""
    dev = out["desc"].device
    p = _loaded("matcher", dtype, dev, fe["n_layers"])
    w, h = fe["normalize_size"]
    kps = normalize_keypoints(out["xy"].to(dtype), float(w), float(h))
    desc, live = out["desc"].to(dtype), out["mask"].bool()
    js, vs = [], []
    for s in range(0, pairs.shape[0], chunk):
        i, j = pairs[s:s + chunk, 0].long(), pairs[s:s + chunk, 1].long()
        scores = assignment(p, fe["n_layers"], kps[i], desc[i], live[i], kps[j], desc[j], live[j],
                            rnd)
        mj, mv = mutual_matches(scores, live[i], fe["threshold"])
        js.append(mj)
        vs.append(mv)
    if not js:
        e = torch.zeros((0, desc.shape[1]), dtype=torch.long, device=dev)
        return e, e.bool()
    return torch.cat(js), torch.cat(vs)


CONTROLS = {"bf16": (torch.bfloat16, _same), "tf32": (torch.float32, round_tf32)}


def reference_matches(out: dict, pairs, spec: dict, control=None):
    """The float64 matcher on the program's real pairs: (match_j, valid,
    substitute); ``substitute`` is the control matcher's (match_j, valid)
    with control "bf16" or "tf32" (``CONTROLS``), else None."""
    fe, chunk = spec["frontend"], spec["pair_chunk"]
    rj, rv = match_pairs(out, pairs, fe, chunk)
    substitute = (match_pairs(out, pairs, fe, chunk, *CONTROLS[control]) if control in CONTROLS
                  else None)
    return rj, rv, substitute
