"""Streaming (SENSOR-type) incremental reconstruction (port of
eacham_tpu/sfm/streaming.py).

The reference declares a SENSOR modality next to DATASET
(modules/base/data_source/DataSourceTypes.h:7-18) but ships no working
streaming reconstruction. Here the pipeline consumes frames AS THEY ARRIVE
from any ``FrameSource`` (io/stream.py):

    rec = StreamingReconstructor(image_size=(W, H), max_frames=64)
    for window in windows:
        stats = rec.process(window)        # extract + match + register
    rec.checkpoint("state.npz")            # resumable any time

Every array (frames, descriptor table, pair tables, landmarks) is
preallocated at ``max_frames`` capacity and masked: arriving frames fill
rows in place, so each stage sees one shape over the whole stream. The
descriptor table ``[max_frames, K, 256]`` lives on the device beside the
scene; only the pooled per-frame descriptors that pick retrieval pairs are
kept on the host.

Matching is incremental: each new frame is paired with its ``window``
predecessors plus ``retrieval_k`` pooled-descriptor retrievals over the
arrived frames before that window, and only those new pair rows are
matched (one launch of the batched matcher a window, over the whole table
with the unarrived rows masked) and written into the tables.

``process`` and ``finalize`` are root spans of ``utils.timer``
(``sfm.streaming.process`` / ``.finalize``, tagged with the
reconstructor's ``stream`` number); a window's stages are the spans
``sfm.streaming.process.extract``, ``.pairs`` (the pooled descriptors and
the candidate pairs), ``.match``, ``.init`` and ``.resume``.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np
import torch

from eacham_tpu_torch.device import as_tensor, resolve_device
from eacham_tpu_torch.features.frontend import extract_features
from eacham_tpu_torch.features.matching import match_all_pairs
from eacham_tpu_torch.geometry.camera import intrinsics_from_image_size
from eacham_tpu_torch.sfm.matches import invert_matches
from eacham_tpu_torch.sfm.pipeline import (
    SfmOptions, rank_init_pairs, resume_sfm, seed_initial_pair,
)
from eacham_tpu_torch.sfm.scene import make_scene
from eacham_tpu_torch.sfm.twoview import find_best_pair
from eacham_tpu_torch.utils import timer


class StreamingReconstructor:
    """Incremental SfM over an arriving frame stream, on ``device`` (the
    card by default; ``device="cpu"`` runs the plain versions)."""

    _numbers = itertools.count()

    def __init__(
        self,
        image_size: tuple[int, int],
        intr=None,
        options: SfmOptions = SfmOptions(),
        max_frames: int = 64,
        window: int = 6,
        retrieval_k: int = 2,
        desc_dim: int = 256,
        finalize_every: int = 1,
        device: str | torch.device | None = "cuda",
    ):
        dev = resolve_device(device)
        self._setup(image_size, options, window, retrieval_k, finalize_every, dev)
        K = options.max_features
        N = max_frames
        self.K = K
        self.max_frames = max_frames
        self.pair_capacity = max_frames * (window + retrieval_k)

        self.desc = torch.zeros((N, K, desc_dim), dtype=torch.float32, device=dev)
        self.pooled = np.zeros((N, desc_dim), np.float32)
        intr = (as_tensor(intr, dev, torch.float32) if intr is not None
                else intrinsics_from_image_size(*image_size, device=dev))
        P = self.pair_capacity

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.scene = make_scene(
            keypoints=zeros(N, K, 2, dtype=torch.float32),
            kp_mask=zeros(N, K, dtype=torch.bool),
            pair_idx=zeros(P, 2, dtype=torch.int32),
            pair_ok=zeros(P, dtype=torch.bool),
            match_ij=zeros(P, K, dtype=torch.int32),
            valid_ij=zeros(P, K, dtype=torch.bool),
            match_ji=zeros(P, K, dtype=torch.int32),
            valid_ji=zeros(P, K, dtype=torch.bool),
            intr=intr,
            lm_capacity=options.lm_capacity or min(N * K, 1 << 17),
        )
        self.n_frames = 0          # arrived frames
        self.pair_cursor = 0       # filled pair rows
        self.initialized = False
        self.names: list[str] = []

    def _setup(self, image_size, options, window, retrieval_k, finalize_every, dev):
        self.image_size = image_size
        self.opt = options
        self.window = window
        self.retrieval_k = retrieval_k
        # sensor-rate amortization: the global-BA finalize is the
        # superlinear per-window cost (it solves ALL arrived frames); run
        # it on every k-th window only — in between, new frames get the
        # sweep's local-window refinement, which is O(window) per frame.
        # Callers polish on demand with .finalize() at stream end.
        self.finalize_every = max(1, int(finalize_every))
        self._windows_seen = 0
        self.device = dev
        self.stream = next(self._numbers)     # the spans' tag

    # ---- internals --------------------------------------------------------

    def _new_pairs(self, first: int, last: int) -> np.ndarray:
        """Candidate pairs touching frames [first, last): window ∪
        retrieval, global frame indices, i < j, sorted and unique."""
        pairs = []
        for j in range(first, last):
            lo = max(0, j - self.window)
            for i in range(lo, j):
                pairs.append((i, j))
            if self.retrieval_k > 0 and j - self.window > 0:
                sims = self.pooled[: j - self.window] @ self.pooled[j]
                k = min(self.retrieval_k, sims.shape[0])
                top = np.argpartition(-sims, k - 1)[:k]
                pairs.extend((int(t), j) for t in top)
        if not pairs:
            return np.zeros((0, 2), np.int32)
        return np.unique(np.asarray(pairs, np.int32), axis=0)

    # ---- public API -------------------------------------------------------

    @torch.no_grad()
    def process(self, images, names=None, verbose: bool = False) -> dict:
        """Integrate a window of frames: extract, match against the recent
        past, register (and initialize once enough parallax arrives).

        ``images``: [M, H, W] float grayscale in [0, 1] (numpy or tensor).
        Returns the run stats of the post-arrival registration sweep, with
        ``arrived`` and the window's ``new_pairs``.
        """
        with timer.span("sfm.streaming.process", stream=self.stream):
            return self._process(images, names, verbose)

    def _process(self, images, names, verbose: bool) -> dict:
        dev = self.device
        m = int(images.shape[0])
        s = self.n_frames
        if s + m > self.max_frames:
            raise ValueError(
                f"stream capacity exceeded ({s}+{m} > {self.max_frames})"
            )
        self.names.extend(
            names if names is not None else
            [f"frame_{s + i:05d}" for i in range(m)]
        )

        with timer.span("sfm.streaming.process.extract"):
            xy, desc, _, mask = extract_features(images, max_keypoints=self.K, device=dev)
            self.desc[s:s + m] = desc
            sc = self.scene
            keypoints, kp_mask = sc.keypoints.clone(), sc.kp_mask.clone()
            keypoints[s:s + m] = xy
            kp_mask[s:s + m] = mask
            sc = sc._replace(keypoints=keypoints, kp_mask=kp_mask)
        with timer.span("sfm.streaming.process.pairs"):
            pooled = (desc * mask[..., None]).sum(1)
            pooled = pooled / torch.clamp(
                torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-8)
            self.pooled[s:s + m] = pooled.cpu().numpy()
            self.n_frames = s + m
            new_pairs = self._new_pairs(s, s + m)

        # --- match the new candidate pairs only ---------------------------
        if new_pairs.shape[0]:
            c = self.pair_cursor
            if c + new_pairs.shape[0] > self.pair_capacity:
                raise ValueError("pair capacity exceeded")
            with timer.span("sfm.streaming.process.match"):
                pairs = torch.as_tensor(new_pairs, device=dev)
                mj, mv, ok = match_all_pairs(
                    self.desc, sc.kp_mask, pairs,
                    ratio=self.opt.match_ratio,
                    min_matches=self.opt.min_matches,
                    chunk=self.opt.match_chunk,
                )
                mv = mv & ok[:, None]
                mji, mvi = invert_matches(mj, mv)
                e = c + new_pairs.shape[0]
                upd = {}
                for name, rows in (("pair_idx", pairs), ("pair_ok", ok), ("match_ij", mj),
                                   ("valid_ij", mv), ("match_ji", mji), ("valid_ji", mvi)):
                    t = getattr(sc, name).clone()
                    t[c:e] = rows.to(t.dtype)
                    upd[name] = t
                sc = sc._replace(**upd)
            self.pair_cursor = e
        self.scene = sc

        # --- initialize once, then sweep ----------------------------------
        if not self.initialized:
            with timer.span("sfm.streaming.process.init"):
                self._initialize()
        if not self.initialized:
            return {"initialized": False, "registered": 0,
                    "arrived": self.n_frames, "new_pairs": int(new_pairs.shape[0])}

        self._windows_seen += 1
        do_finalize = (self._windows_seen % self.finalize_every == 0)
        with timer.span("sfm.streaming.process.resume"):
            self.scene, stats = resume_sfm(
                self.scene, options=self.opt, verbose=verbose,
                finalize=do_finalize, device=dev)
        stats.update(arrived=self.n_frames, new_pairs=int(new_pairs.shape[0]))
        return stats

    def _initialize(self) -> None:
        """Search the arrived frames for an initial pair and seed the map
        from it if one passes."""
        score_r = rank_init_pairs(self.scene, float(max(self.image_size))).cpu().numpy()
        order = np.argsort(-score_r)
        order = order[score_r[order] > 0]
        if not order.size:
            return
        generator = torch.Generator(device=self.device).manual_seed(self.opt.seed)
        pair_row, init = find_best_pair(
            generator, self.scene, order,
            min_initial_inliers=self.opt.min_initial_inliers,
            max_repr_error=self.opt.init_max_repr_error,
            min_tri_angle=self.opt.init_min_tri_angle,
            chunk=self.opt.init_chunk,
            n_hyp_e=self.opt.ransac_hyps_e,
            n_hyp_h=self.opt.ransac_hyps_h,
        )
        if pair_row is not None:
            self.scene = seed_initial_pair(
                self.scene, pair_row, init.T, init.points, init.point_ok)
            self.initialized = True

    @torch.no_grad()
    def finalize(self, verbose: bool = False) -> dict:
        """Run the full global-BA finalization on demand (stream end)."""
        with timer.span("sfm.streaming.finalize", stream=self.stream):
            self.scene, stats = resume_sfm(
                self.scene, options=self.opt, verbose=verbose, finalize=True,
                device=self.device)
        stats["arrived"] = self.n_frames
        return stats

    # ---- persistence ------------------------------------------------------

    def checkpoint(self, path: str | Path) -> None:
        """The scene and the stream's state in the reference's checkpoint
        layout (the descriptor table as ``extra_desc``)."""
        from eacham_tpu_torch.io.checkpoint import save_scene

        save_scene(
            path, self.scene,
            n_frames=np.int32(self.n_frames),
            pair_cursor=np.int32(self.pair_cursor),
            initialized=np.bool_(self.initialized),
            desc=self.desc,
            pooled=self.pooled,
            names=np.asarray(self.names),
        )

    @classmethod
    def restore(cls, path: str | Path, image_size, options=SfmOptions(),
                window: int = 6, retrieval_k: int = 2,
                finalize_every: int = 1, device: str | torch.device | None = "cuda"):
        """A reconstructor continuing from ``checkpoint``'s file (either
        package's)."""
        from eacham_tpu_torch.io.checkpoint import load_scene

        dev = resolve_device(device)
        scene, extra = load_scene(path, device=dev)
        self = cls.__new__(cls)
        self._setup(image_size, options, window, retrieval_k, finalize_every, dev)
        self.K = scene.kp_mask.shape[1]
        self.max_frames = scene.kp_mask.shape[0]
        self.pair_capacity = scene.pair_idx.shape[0]
        self.scene = scene
        self.desc = torch.as_tensor(extra["desc"], dtype=torch.float32, device=dev)
        self.pooled = np.array(extra["pooled"], np.float32)
        self.n_frames = int(extra["n_frames"])
        self.pair_cursor = int(extra["pair_cursor"])
        self.initialized = bool(extra["initialized"])
        self.names = [str(n) for n in extra["names"]]
        return self
