"""Extract + match two images and save a match overlay, on the PyTorch/CUDA
port.

The port's counterpart of ``examples/extract_match.py`` (the reference's
``lightglue_seq`` example binary, extract_match.cpp:14-68): resize to
max-dim 512, extract, match, draw. ``--frontend classical`` runs the DoG
detector and the dense descriptor, then ``features.matching.match_pair``:
one launch of the batched matcher's CUDA kernel (``csrc/match_pairs.cu``)
on a two-row table. ``--frontend deep`` runs SuperPoint and LightGlue, the
attention of every LightGlue block in ``csrc/masked_attention.cu``: with
``--weights DIR`` the weights there (the layer count from its
``lightglue.meta``, so the shipped 3-layer matcher loads), without it
``init_params`` modules drawn from a seeded ``torch.Generator``.

    python examples/extract_match_torch.py img1.png img2.png [out.png] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card and
without that flag it exits with an error.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def resize_max_dim(img: np.ndarray, max_dim: int = 512) -> np.ndarray:
    """Resize so that max(h, w) == max_dim (bilinear, on 8-bit values), as
    the reference resizes its inputs (extract_match.cpp:21-27); smaller
    images stay as they are."""
    from PIL import Image

    h, w = img.shape
    s = max_dim / max(h, w)
    if s >= 1.0:
        return img
    im = Image.fromarray((img * 255).astype("uint8"))
    im = im.resize((int(w * s), int(h * s)), Image.BILINEAR)
    return np.asarray(im, dtype=np.float32) / 255.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("output", nargs="?", default="matches.png")
    ap.add_argument("--frontend", choices=["classical", "deep"], default="classical")
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--weights", help="directory with the deep models' .npz (and lightglue.meta)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch
    from PIL import Image

    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.utils.viz import draw_matches

    dev = resolve_device(args.device)

    def load(path):
        return np.asarray(Image.open(path).convert("L"), dtype=np.float32) / 255.0

    img1 = resize_max_dim(load(args.image1))
    img2 = resize_max_dim(load(args.image2))
    H = max(img1.shape[0], img2.shape[0])
    W = max(img1.shape[1], img2.shape[1])
    batch = np.zeros((2, H, W), np.float32)
    batch[0, :img1.shape[0], :img1.shape[1]] = img1
    batch[1, :img2.shape[0], :img2.shape[1]] = img2
    images = torch.as_tensor(batch, device=dev)

    if args.frontend == "classical":
        from eacham_tpu_torch.features.frontend import extract_features
        from eacham_tpu_torch.features.matching import match_pair

        xy, desc, score, mask = extract_features(
            images, max_keypoints=args.max_keypoints, device=dev)
        mj, valid = match_pair(desc[0], desc[1], mask[0], mask[1])
    else:
        from eacham_tpu_torch.features.deep import lightglue as lg
        from eacham_tpu_torch.features.deep import superpoint as sp
        from eacham_tpu_torch.features.deep.frontend import (
            load_frontend_params, pad_images_for_conv)

        if args.weights:
            superpoint, matcher, _ = load_frontend_params(weights_dir=args.weights, device=dev)
        else:
            superpoint = sp.init_params(torch.Generator().manual_seed(0)).to(dev).eval()
            matcher = lg.init_params(torch.Generator().manual_seed(0)).to(dev).eval()
        with torch.no_grad():
            # zero-pad to multiples of 8 for the conv encoder
            xy, desc, score, mask = sp.extract_deep(
                superpoint, pad_images_for_conv(images), max_keypoints=args.max_keypoints)
        k0 = lg.normalize_keypoints(xy[0], W, H)[None]
        k1 = lg.normalize_keypoints(xy[1], W, H)[None]
        idx, v, _ = lg.match_deep(matcher, k0, desc[0][None], mask[0][None],
                                  k1, desc[1][None], mask[1][None])
        mj, valid = idx[0], v[0]

    valid = valid.cpu().numpy()
    print(f"{args.frontend}: {int(valid.sum())} matches")
    uv1 = xy[0].cpu().numpy()
    uv2 = xy[1].cpu().numpy()[mj.long().cpu().numpy()]
    draw_matches(img1, img2, uv1, uv2, valid, args.output)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
