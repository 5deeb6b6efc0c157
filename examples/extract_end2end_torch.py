"""End-to-end deep matching on the PyTorch/CUDA port: two images in,
matched pairs out.

The port's counterpart of ``examples/extract_end2end.py`` (the reference's
``lightglue_e2e`` example binary, which runs one fused ONNX graph of
SuperPoint and LightGlue). ``eacham_tpu_torch.features.deep.frontend.
match_images_e2e`` runs SuperPoint extraction and LightGlue matching on the
card in one call, with the attention of every LightGlue block in the
port's CUDA kernel (``csrc/masked_attention.cu``); keypoints and
descriptors stay on the card between the stages.

    python examples/extract_end2end_torch.py img1.png img2.png [out.png] [--device cpu]

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
    the reference resizes its e2e inputs; smaller images stay as they are."""
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
    ap.add_argument("output", nargs="?", default="matches_e2e.png")
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--weights", help="directory with deep-frontend .npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from PIL import Image

    from eacham_tpu_torch.features.deep.frontend import load_frontend_params, match_images_e2e
    from eacham_tpu_torch.utils.viz import draw_matches

    superpoint, matcher, _ = load_frontend_params(args.weights, device=args.device)

    def load(path):
        return np.asarray(Image.open(path).convert("L"), dtype=np.float32) / 255.0

    img1 = resize_max_dim(load(args.image1))
    img2 = resize_max_dim(load(args.image2))
    H = max(img1.shape[0], img2.shape[0])
    W = max(img1.shape[1], img2.shape[1])
    batch = np.zeros((2, H, W), np.float32)
    batch[0, :img1.shape[0], :img1.shape[1]] = img1
    batch[1, :img2.shape[0], :img2.shape[1]] = img2

    uv0, uv1, valid, mscore = match_images_e2e(
        superpoint, matcher, batch, max_keypoints=args.max_keypoints,
        threshold=args.threshold, device=args.device)

    v = valid.cpu().numpy()
    print(f"e2e: {int(v.sum())} matches (mean score {float(mscore[valid].mean()):.3f})"
          if v.any() else "e2e: 0 matches")
    draw_matches(img1, img2, uv0.cpu().numpy(), uv1.cpu().numpy(), v, args.output)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
