#!/usr/bin/env python3
"""Does the port give one reconstruction per input? Runs an SfM path twice
in one process on the same input and finds the first call whose output
differs between the runs.

    python scripts/repeat_probe_torch.py [--path sfm|rgbd|both] [--device cuda]

``sfm``: ``chip_smoke.run_full`` (the bench's 100 frames, ``extract_features``
-> ``run_sfm`` at the bench's options); ``rgbd``: ``chip_smoke.run_rgbd``
(the TUM recipe, ``run_sfm_rgbd``; the second run reads the first's TUM
directory). The phases' own checks print instead of raising. Every function of the SfM modules, the
BA core, the geometry and the frontend is wrapped, in the namespace of the
module that calls it, by a recorder that fingerprints what it returns (an
integer sum of its bytes, weighted by position, computed on the device).
The two runs' records are compared in call order: the first record that
differs names the innermost call that parted first. Prints one JSON line a
path: records per run, the first differing record (or null) and a sha256
of each run's final poses and points. Exits non-zero if a path's runs
differ. Needs a CUDA card unless ``--device cpu`` (then ``N_FRAMES`` and
the recipe's frame count are cut with ``--frames``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MODULES = (
    "eacham_tpu_torch.sfm.pipeline", "eacham_tpu_torch.sfm.device_loop",
    "eacham_tpu_torch.sfm.rgbd", "eacham_tpu_torch.sfm.scene",
    "eacham_tpu_torch.sfm.triangulate", "eacham_tpu_torch.sfm.twoview",
    "eacham_tpu_torch.sfm.matches", "eacham_tpu_torch.sfm.filtering",
    "eacham_tpu_torch.ba.core", "eacham_tpu_torch.parallel.ba",
    "eacham_tpu_torch.geometry.pnp", "eacham_tpu_torch.geometry.ransac",
    "eacham_tpu_torch.geometry.epipolar", "eacham_tpu_torch.geometry.triangulation",
    "eacham_tpu_torch.features.frontend", "eacham_tpu_torch.features.matching",
)


def _fingerprints(x, out: list) -> None:
    import torch

    if isinstance(x, torch.Tensor):
        flat = x.detach().contiguous().reshape(-1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        b = flat.view(torch.uint8).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        out.append(str(tuple(x.shape)))
        out.append((b * w).sum())
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            if k != "seconds":              # wall time differs on every run
                out.append(str(k))
                _fingerprints(x[k], out)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _fingerprints(y, out)
    elif isinstance(x, (int, float, str, bool)) or x is None:
        out.append(repr(x))


def fingerprint(x) -> str:
    import torch

    parts: list = []
    _fingerprints(x, parts)
    dev = [p for p in parts if isinstance(p, torch.Tensor)]
    vals = iter(torch.stack(dev).tolist()) if dev else iter(())
    return "|".join(str(next(vals)) if isinstance(p, torch.Tensor) else p for p in parts)


class Recorder:
    """Wraps the modules' functions; ``records`` holds (name, fingerprint)
    in the order in which calls return."""

    def __init__(self):
        self.records: list[tuple[str, str]] = []
        self.saved: list = []

    def __enter__(self):
        # every module is imported before any is wrapped, so that none takes
        # a wrapper into its namespace by importing another
        for mod in [importlib.import_module(name) for name in MODULES]:
            for attr, fn in list(vars(mod).items()):
                if (isinstance(fn, types.FunctionType)
                        and getattr(fn, "__module__", "").startswith("eacham_tpu_torch")):
                    self.saved.append((mod, attr, fn))
                    setattr(mod, attr, self._wrap(f"{fn.__module__}.{fn.__name__}", fn))
        return self

    def _wrap(self, name, fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            self.records.append((name, fingerprint(out)))
            return out
        wrapper.__wrapped__ = fn
        return wrapper

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def scene_digest(scene) -> str:
    h = hashlib.sha256()
    for t in (scene.pose, scene.points):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def compare(path: str, runs) -> dict:
    (r0, s0), (r1, s1) = runs
    first = None
    for i, (a, b) in enumerate(zip(r0, r1)):
        if a != b:
            first = {"index": i, "run0": a[0], "run1": b[0],
                     "callers_before": [r[0] for r in r0[max(0, i - 5):i]]}
            break
    if first is None and len(r0) != len(r1):
        first = {"index": min(len(r0), len(r1)), "run0": "end", "run1": "end"}
    return {"probe": path, "records": [len(r0), len(r1)], "first_difference": first,
            "digests": [scene_digest(s0), scene_digest(s1)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("sfm", "rgbd", "both"), default="both")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=0, help="cut both workloads to this many frames")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("repeat_probe: no CUDA device", file=sys.stderr)
            return 1
        from eacham_tpu_torch.ops import build

        build.build()
        card = cs.card_line()
    else:
        card = "cpu"
    print(card, flush=True)
    R = cs._recipe()
    if args.frames:
        cs.N_FRAMES = R.N_FRAMES = args.frames
    cs.OUT = ROOT / "chiprun_out" / "repeat_probe"
    # the phases' own checks print instead of stopping the probe: their
    # repeat check is what this script takes apart
    cs.require = lambda ok, what: ok or print(f"check failed: {what}", flush=True)
    paths = {}
    if args.path in ("sfm", "both"):
        images, poses, intr = cs.render_workload()
        paths["sfm"] = lambda first, run: cs.run_full(images, intr, poses, dev, card, run,
                                                      first=first)
    if args.path in ("rgbd", "both"):
        paths["rgbd"] = lambda first, run: cs.run_rgbd(R, dev, card, first=first)[2::2]
    ok = True
    for path, run_once in paths.items():
        runs = []
        for run in range(2):
            with Recorder() as rec:
                out = run_once(runs[0][2] if runs else None, run)
            runs.append((rec.records, out[0], out))
        res = compare(path, [r[:2] for r in runs])
        print(json.dumps(res), flush=True)
        ok &= res["first_difference"] is None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
