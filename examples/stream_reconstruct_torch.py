"""Streaming reconstruction demo on the PyTorch/CUDA port: a live-style
frame source feeding the incremental pipeline window by window, with
checkpoints between windows.

The port's counterpart of ``examples/stream_reconstruct.py``. Any object
with ``read() -> (id, gray_image, name) | None`` (io/stream.FrameSource)
can replace ReplaySource. Each window is extracted, matched against the
recent past in one launch of the batched matcher's CUDA kernel, and
registered by ``StreamingReconstructor``; the checkpoint is written after
every window in the JAX package's ``.npz`` layout, so either package can
restore it. The reconstruction's thresholds are ``SfmOptions``' defaults,
as in the reference example (450 initial inliers, a 3 deg initial
triangulation angle: the reference's configs/SfmConfig.json), so the
stream needs 450 matches a pair with that much parallax (a camera
sliding past a smooth textured surface at ``--max-keypoints 1024`` gives
them; the matcher's kernel takes at most 1152).

    python examples/stream_reconstruct_torch.py <image_dir> [--window 8] [--device cpu]

Runs on the card unless ``--device cpu`` is given; without a card and
without that flag it exits with an error.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image_dir")
    ap.add_argument("--window", type=int, default=8,
                    help="frames per processing window")
    ap.add_argument("--max-frames", type=int, default=128)
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--checkpoint", default="stream_state.npz")
    ap.add_argument("--out", default="transform.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from eacham_tpu_torch.device import resolve_device
    from eacham_tpu_torch.io.saver import save_positions
    from eacham_tpu_torch.io.stream import ReplaySource, frames
    from eacham_tpu_torch.sfm import SfmOptions
    from eacham_tpu_torch.sfm.streaming import StreamingReconstructor

    dev = resolve_device(args.device)
    source = ReplaySource(args.image_dir)
    rec = None
    window_imgs, window_names = [], []

    def flush():
        nonlocal rec
        if not window_imgs:
            return
        imgs = np.stack(window_imgs)
        if rec is None:
            h, w = imgs.shape[1:]
            rec = StreamingReconstructor(
                image_size=(w, h),
                options=SfmOptions(max_features=args.max_keypoints),
                max_frames=args.max_frames, window=args.window, device=dev,
            )
        t0 = time.perf_counter()
        stats = rec.process(imgs, names=list(window_names))
        print(f"[stream] +{imgs.shape[0]} frames -> "
              f"registered {stats.get('registered', 0)}/{stats['arrived']} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        rec.checkpoint(args.checkpoint)
        window_imgs.clear()
        window_names.clear()

    for idx, img, name in frames(source):
        window_imgs.append(img)
        window_names.append(name)
        if len(window_imgs) >= args.window:
            flush()
    flush()

    if rec is None or not rec.initialized:
        print("stream produced no reconstruction")
        return 1

    scene = rec.scene
    valid = scene.pose_valid.cpu().numpy()[: rec.n_frames]
    poses = scene.pose.cpu().numpy()[: rec.n_frames]
    intr = scene.intr.cpu().numpy()
    names = [n for n, v in zip(rec.names, valid) if v]
    save_positions(
        args.out, names, poses[valid],
        width=rec.image_size[0], height=rec.image_size[1],
        cx=float(intr[2]), cy=float(intr[3]),
        fx=float(intr[0]), fy=float(intr[1]),
    )
    print(f"saved {args.out} ({valid.sum()}/{rec.n_frames} frames), "
          f"checkpoint at {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
