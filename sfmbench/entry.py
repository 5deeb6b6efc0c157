"""The system under test, driven as its users drive it: with the frontend
kinds (``frontends/<kind>.py``), the only modules of the benchmark that
import the program (``eacham_tpu_torch``).

A configuration's entry follows from its inputs: images go through its
frontend kind's ``extract``, then the kind's ``match_tables`` (None: run_sfm
builds its own graph) and ``sfm.pipeline.run_sfm`` (or, in an open loop,
``sfm.streaming.StreamingReconstructor``); tracks go straight into
``run_sfm``.
"""

from __future__ import annotations

import time

import torch

from sfmbench.devtrace import Session
from sfmbench.harness import request_seed

WARMUP_SEED = 2 ** 31        # the warm-up's RANSAC seeds: request indices no window uses
RUN_SFM_KERNELS = ["match_pairs"]   # run_sfm's own match graph, which tracks go through


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """One configuration's inputs on the device and its entry points.
    ``frontend``: the configuration's frontend kind (``harness.cell``'s
    ``frontend``; None for tracks)."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int,
                 dev: torch.device, frontend):
        from eacham_tpu_torch.sfm.pipeline import SfmOptions

        self.config, self.traffic, self.dev, self.seed = config, traffic, dev, seed
        self.options = dict(config["options"])
        self.SfmOptions = SfmOptions
        self.size = tuple(inputs["size"])
        self.intr = inputs["intr"]
        self.images = (torch.as_tensor(inputs["images"], device=dev)
                       if "images" in inputs else None)
        self.tracks = (tuple(torch.as_tensor(inputs[k], device=dev)
                             for k in ("keypoints", "descriptors", "mask"))
                       if "keypoints" in inputs else None)
        self.frames = (self.images if self.images is not None else self.tracks[0]).shape[0]
        self.frontend = frontend
        self.frontend_state = frontend.setup(self) if frontend is not None else None

    def build(self) -> dict:
        """The kernels of the path, built (or found built) up front."""
        from eacham_tpu_torch.ops import build

        if self.dev.type != "cuda":
            return {}
        return build.build(self.frontend.kernels(self.config) if self.frontend is not None
                           else RUN_SFM_KERNELS)

    # ---- the closed loop ---------------------------------------------------------

    def reconstruct(self, k: int, frames: int | None = None, profile: bool = False) -> dict:
        """One whole request: the features (extracted, or the tracks) of the
        first ``frames`` frames, the kind's match tables where it builds them
        (``tables_s``; None where run_sfm builds its own), then ``run_sfm``
        with RANSAC seed (seed, k)."""
        from eacham_tpu_torch.sfm.pipeline import run_sfm

        n = frames or self.frames
        opts = self.SfmOptions(seed=request_seed(self.seed, k), **self.options)
        # run_sfm's own generator (seeded from opts.seed), shared with the kind's tables
        gen = torch.Generator(device=self.dev).manual_seed(opts.seed)
        session = Session(self.dev) if profile else None
        sync(self.dev)
        if session:
            session.start()
        t0 = time.perf_counter()
        if self.images is not None:
            xy, desc, mask = self.frontend.extract(self, self.images[:n])
            sync(self.dev)
        else:
            xy, desc, mask = (t[:n] for t in self.tracks)
        t1 = time.perf_counter()
        tables = None
        if self.frontend is not None:
            tables = self.frontend.match_tables(self, xy, desc, mask, opts, gen)
            if tables is not None:
                sync(self.dev)
        t_tables = time.perf_counter()
        scene, stats = run_sfm(xy, desc, mask, image_size=self.size, intr=self.intr,
                               options=opts, match_tables=tables, generator=gen,
                               device=self.dev)
        sync(self.dev)
        t2 = time.perf_counter()
        if session:
            session.stop()
        return {"k": k, "frames": n, "registered": stats["registered"],
                "extract_s": t1 - t0 if self.images is not None else None,
                "tables_s": t_tables - t1 if tables is not None else None,
                "total_s": t2 - t0, "seconds": dict(stats["seconds"]),
                "profiled": profile,
                "trace": session.trace if session else None,
                "out": {"xy": xy, "desc": desc, "mask": mask, "scene": scene._asdict()}}

    def warmup_closed(self) -> None:
        self.reconstruct(WARMUP_SEED, frames=self.traffic["warmup_frames"])

    # ---- the open loop -----------------------------------------------------------

    def stream(self, s: int, frames: int | None = None, profile: bool = False):
        return Stream(self, s, frames or self.traffic["stream_frames"], profile)

    def warmup_open(self) -> None:
        st = self.stream(WARMUP_SEED, frames=self.traffic["warmup_frames"])
        for c in range(self.traffic["warmup_frames"] // self.traffic["chunk"]):
            st.process(c)
        st.finalize()


class Stream:
    """One stream of the open loop: a new ``StreamingReconstructor`` fed the
    configuration's frames chunk by chunk."""

    def __init__(self, prog: Program, s: int, frames: int, profile: bool):
        from eacham_tpu_torch.sfm.streaming import StreamingReconstructor

        t = prog.traffic
        self.prog, self.frames, self.chunk = prog, frames, t["chunk"]
        opts = prog.SfmOptions(seed=request_seed(prog.seed, s), **prog.options)
        self.session = Session(prog.dev) if profile else None
        if self.session:
            self.session.start()
        self.rec = StreamingReconstructor(
            prog.size, intr=prog.intr, options=opts, max_frames=t["stream_frames"],
            window=t["window"], retrieval_k=t["retrieval_k"],
            finalize_every=t["finalize_every"], device=prog.dev)
        self.last = {}

    def _valid(self):
        sync(self.prog.dev)
        return self.rec.scene.pose_valid[:self.frames].cpu().numpy()

    def process(self, c: int):
        t0 = time.perf_counter()
        st = self.rec.process(self.prog.images[c * self.chunk:(c + 1) * self.chunk])
        valid = self._valid()
        self.last = {"span_s": time.perf_counter() - t0, "global_ba": "global_ba" in st,
                     "registered": st.get("registered", 0),
                     "profiled": self.session is not None}
        return valid

    def finalize(self):
        self.rec.finalize()
        valid = self._valid()
        if self.session:
            self.session.stop()
        sc = self.rec.scene
        self.out = {"xy": sc.keypoints, "desc": self.rec.desc, "mask": sc.kp_mask,
                    "scene": sc._asdict()}
        return valid
