"""The registration sweep: next-best-view selection, PnP registration,
two-pass triangulation and windowed local bundle adjustment, frame after
frame (port of eacham_tpu/sfm/device_loop.py).

The reference compiles the whole loop into one on-device program; here it
is a host loop over tensor ops whose state stays on the device. Per
registration the host reads back the candidate (frames and score), its PnP
inlier count and, when a local BA is due, the window's landmark count and
one flag per LM iteration; each read is counted (``utils.timer.readback``).

A registration's three fixed-shape stages, each a long chain of small
kernels, run as CUDA graphs on a card: PnP (``pnp_stage``: the observers'
gather, RANSAC on uniforms drawn beforehand from the run's generator, the
Gauss-Newton polish, the inlier count), ``set_pose`` with the first
triangulation pass, and the second pass (``triangulate_stage``). The frame
enters them as a device tensor, so nothing of one frame is fixed in a
graph. ``GraphCache`` runs a stage's key (device, stage, every input's shape
and dtype, its options) eagerly on its first use, captures it on its second
and replays it after that. On the CPU every stage runs eagerly. The two host
decisions between the stages (the inlier gate and the local-BA cadence)
keep them apart. The local BA reads the window's landmark count and one
flag an LM iteration back; each LM iteration of its dense solver goes
through the same cache (``ba.core._lm_iteration``: one graph a window
size, replayed in every iteration of every window).

Each iteration's stages are spans of ``utils.timer`` (recorded while a
profiler runs): ``sfm.device_loop.next_view``, ``.pnp``, ``.triangulate``
(both passes; the first holds ``set_pose``) and ``.local_ba`` (the window
build, ``refine_ba`` and the scatters; its count ``iterations``). A graphed
stage counts ``graph_captures`` or ``graph_replays`` on its span, a graphed
LM iteration ``lm_graph_captures`` or ``lm_graph_replays``.
``registered`` and ``pnp_failed`` are counted on the caller's span
(``sfm.device_loop`` in ``sfm/pipeline.py``).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from functools import partial

import torch

from eacham_tpu_torch.ba.core import BAConfig, refine_ba
from eacham_tpu_torch.geometry.ransac import draw_uniforms
from eacham_tpu_torch.sfm.pipeline import (
    local_neighbors, next_best_view, pnp_register, set_pose, sync_ranks,
)
from eacham_tpu_torch.sfm.scene import (
    Scene, ba_problem_windowed, scatter_window_points, scatter_window_poses,
)
from eacham_tpu_torch.sfm.triangulate import triangulate_frame
from eacham_tpu_torch.utils import timer

_POSED = ("pose", "pose_valid")
_MAPPED = ("points", "lm_valid", "n_landmarks", "kp2lm")


def pnp_stage(t: dict, n_hyp: int, pair_only: bool) -> dict:
    """``pnp_register`` of frame ``t["cur"]`` (prev ``t["prev"]``, its pair
    rows ``t["pair_rows"]``, RANSAC uniforms ``t["u"]``) on the scene whose
    fields ``t`` holds. Returns {"T", "n_inl"}."""
    T, n_inl = pnp_register(Scene(*(t[f] for f in Scene._fields)), t["prev"], t["cur"],
                            t["pair_rows"], threshold=4.0, n_hyp=n_hyp, pair_only=pair_only,
                            uniforms=t["u"])
    return {"T": T, "n_inl": n_inl}


def triangulate_stage(t: dict, min_observers: int, max_repr_error: float,
                      min_tri_angle: float, max_observers: int) -> dict:
    """``triangulate_frame`` of frame ``t["cur"]`` on the scene whose fields
    ``t`` holds, after ``set_pose`` at ``t["T"]`` where ``t`` has one.
    Returns the fields it wrote."""
    scene = Scene(*(t[f] for f in Scene._fields))
    posed = "T" in t
    if posed:
        scene = set_pose(scene, t["cur"], t["T"])
    scene, _, _ = triangulate_frame(scene, t["cur"], t["pair_rows"], min_observers,
                                    max_repr_error, min_tri_angle, max_observers=max_observers)
    return {f: getattr(scene, f) for f in (_POSED if posed else ()) + _MAPPED}


def cuda_capture(fn, static: dict):
    """``fn(static)`` captured as a CUDA graph on a side stream, after the
    card has caught up (a host wait once a capture). Returns (replay,
    outputs): each ``replay()`` reruns the capture's kernels on the current
    stream, writing the same output tensors."""
    dev = next(iter(static.values())).device
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn(static)
        finally:
            graph.capture_end()
    return graph.replay, out


def _stamp(v: torch.Tensor):
    """The tensor and its count of in-place writes (None for an inference
    tensor, which keeps no count: it is copied in on every call)."""
    return weakref.ref(v), (None if v.is_inference() else v._version)


class StageGraph:
    """One stage recorded over static copies of its inputs (``record``:
    ``cuda_capture``). A call copies in each input that is not the tensor
    last copied, or was written in place since, replays, and returns copies
    of the outputs: nothing returned aliases the graph's buffers."""

    def __init__(self, fn, inputs: dict, record=cuda_capture):
        self.static = {k: v.clone() for k, v in inputs.items()}
        self.seen = {k: _stamp(v) for k, v in inputs.items()}
        self.replay, self.out = record(fn, self.static)

    def __call__(self, inputs: dict) -> dict:
        for k, v in inputs.items():
            ref, version = self.seen[k]
            if ref() is not v or version is None or v._version != version:
                self.static[k].copy_(v)
                self.seen[k] = _stamp(v)
        self.replay()
        return {k: v.clone() for k, v in self.out.items()}


class GraphCache:
    """Stages by key, the ``size`` most recently used: a key's first use
    runs its stage eagerly, its second captures it (``capture(fn, inputs)``
    gives a callable of the inputs) and runs the capture, later uses run
    that. Counts ``<counter>_captures`` and ``<counter>_replays`` on the
    innermost span."""

    def __init__(self, size: int = 8, capture=StageGraph):
        self.size, self.capture = size, capture
        self.entries: OrderedDict = OrderedDict()     # key -> None once seen, then the graph

    def run(self, key, fn, inputs: dict, counter: str = "graph") -> dict:
        if key not in self.entries:
            self._keep(key, None)
            return fn(inputs)
        graph = self.entries[key]
        if graph is None:
            graph = self.capture(fn, inputs)
            timer.add(f"{counter}_captures")
        else:
            timer.add(f"{counter}_replays")
        self._keep(key, graph)
        return graph(inputs)

    def _keep(self, key, graph) -> None:
        self.entries[key] = graph
        self.entries.move_to_end(key)
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)


# one cache for the process: a request's graphs are replayed by the next
# request of the same shapes
_GRAPHS = GraphCache()


def _graphable(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _staged(stage, inputs: dict, counter: str = "graph", **options) -> dict:
    """``stage(inputs, **options)``: through ``_GRAPHS`` on a CUDA card,
    keyed by the device (the first input's), the thread (a graph's static
    buffers serve one thread), the stage, every input's shape and dtype and
    the options, its captures and replays counted under ``counter``;
    eagerly elsewhere. Besides the sweep's stages it runs the BA's LM
    iteration (``ba.core._lm_iteration``, counter ``lm_graph``) and a
    sharded BA's dense CG (``ba.core._jacobi_cg``)."""
    dev = next(iter(inputs.values())).device
    if not _graphable(dev):
        return stage(inputs, **options)
    key = (dev, threading.get_ident(), stage.__name__,
           tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()),
           tuple(sorted(options.items())))
    return _GRAPHS.run(key, partial(stage, **options), inputs, counter)


@torch.no_grad()
def registration_sweep_step(
    scene: Scene,
    excluded: torch.Tensor,      # [N] bool
    fp_tbl: torch.Tensor,        # [N, D] frame_pair_table
    generator: torch.Generator | None,
    max_repr_error: float,
    min_tri_angle: float,
    min_pnp_inliers: int = 15,
    min_ba_landmarks: int = 50,
    ba_cfg: BAConfig = BAConfig(),
    max_observers: int = 12,
    n_hyp_pnp: int = 512,
    pnp_pair_only: bool = False,
    ba_max_cams: int = 16,
    ba_max_obs: int = 16384,
    ba_max_lms: int | None = None,
    max_steps: int | None = None,
    ba_every: int = 1,
    ba_free_span: int = 0,
    local_ba: dict | None = None,
):
    """Register up to ``max_steps`` frames. Returns (scene, excluded,
    n_registered, more), ``more`` meaning that the loop stopped on the step
    limit with candidates remaining.

    Per iteration: next_best_view -> PnP (gate: ``min_pnp_inliers``) ->
    triangulate(2 observers) -> local BA on every ``ba_every``-th
    iteration (gate: ``min_ba_landmarks``) -> triangulate(3 observers). A
    frame whose PnP fails is marked excluded and never tried again.
    ``local_ba``: a dict whose ``calls`` and ``iterations`` each local BA
    run adds to.
    """
    N, K = scene.kp_mask.shape
    dev = scene.kp_mask.device
    limit = N if max_steps is None else min(max_steps, N)
    n_reg, it, has = 0, 0, True
    while it < limit:
        with timer.span("sfm.device_loop.next_view"):
            view = torch.stack(next_best_view(scene, excluded))
            prev, cur, score = (int(v) for v in timer.readback(torch.Tensor.tolist, view))
        has = score >= 0
        if not has:
            break
        # the frame as the stages take it: device tensors, and its pair rows
        frame = {"cur": view[1:2], "pair_rows": fp_tbl[cur]}
        with timer.span("sfm.device_loop.pnp"):
            u = draw_uniforms(generator, (), n_hyp_pnp, K, dev)
            out = _staged(pnp_stage, {**scene._asdict(), **frame, "prev": view[0:1], "u": u},
                          n_hyp=n_hyp_pnp, pair_only=pnp_pair_only)
            n_inl = timer.readback(int, out["n_inl"])
        if n_inl >= min_pnp_inliers:
            scene = _register(scene, cur, frame, out["T"], it, max_repr_error, min_tri_angle,
                              min_ba_landmarks, ba_cfg, max_observers, ba_max_cams,
                              ba_max_obs, ba_max_lms, ba_every, ba_free_span, local_ba)
            n_reg += 1
            timer.add("registered")
        else:
            excluded = excluded.clone()
            excluded[cur] = True
            timer.add("pnp_failed")
        it += 1
    return scene, excluded, n_reg, has and it >= limit


def _register(scene, cur, frame, T, it, max_repr_error, min_tri_angle, min_ba_landmarks,
              ba_cfg, max_observers, ba_max_cams, ba_max_obs, ba_max_lms, ba_every,
              ba_free_span, local_ba):
    """Take frame ``cur`` (``frame``: the stages' form of it) into the map
    with pose ``T``."""
    tri = dict(max_repr_error=max_repr_error, min_tri_angle=min_tri_angle,
               max_observers=max_observers)
    with timer.span("sfm.device_loop.triangulate"):
        scene = scene._replace(**_staged(triangulate_stage, {**scene._asdict(), **frame, "T": T},
                                         min_observers=2, **tri))
    # local BA is a large share of the sweep's cost; ba_every > 1 spreads it over
    # registrations, and the frames it skips are refined by the next window
    # that holds them and by the interim and global BA
    if it % ba_every == 0:
        with timer.span("sfm.device_loop.local_ba") as sp:
            # the local problem is compacted to a fixed window: the new frame's
            # neighbourhood is small at any scene size
            nb = local_neighbors(scene, cur)
            prob, cam_list, cam_on, lm_list, lm_on = ba_problem_windowed(
                scene, nb, max_cams=ba_max_cams, max_obs=ba_max_obs, cur=cur,
                max_lms=ba_max_lms, free_span=ba_free_span)
            if timer.readback(int, prob.pt_in_ba.sum()) >= min_ba_landmarks:
                poses, points, intr, info = refine_ba(prob, ba_cfg)
                sp.add("iterations", info["iterations"])
                if local_ba is not None:
                    local_ba["calls"] += 1
                    local_ba["iterations"] += info["iterations"]
                scene = scatter_window_poses(scene, cam_list, cam_on, poses)
                scene = scatter_window_points(scene, lm_list, lm_on, points)
                scene = scene._replace(intr=intr)
    with timer.span("sfm.device_loop.triangulate"):
        scene = scene._replace(**_staged(triangulate_stage, {**scene._asdict(), **frame},
                                         min_observers=3, **tri))
    return scene


def registration_sweep(scene: Scene, excluded: torch.Tensor, fp_tbl: torch.Tensor,
                       generator: torch.Generator | None, max_repr_error: float,
                       min_tri_angle: float, segment: int = 0, on_segment=None, mesh=None,
                       **kw):
    """Register every reachable frame. Returns (scene, excluded,
    n_registered).

    ``segment`` > 0 splits the sweep into runs of that many iterations;
    ``on_segment(scene) -> scene`` runs between segments (not after the
    last one): the hook for interim global BA, which arrests the pose drift
    that a purely local-window sweep accumulates over hundreds of frames.
    The local-BA cadence ``ba_every`` counts iterations within a segment.

    Under a ``mesh`` of several ranks every rank sweeps on its own, and
    after each segment all take rank 0's scene state, ``excluded`` and
    decision to go on (``pipeline.sync_ranks``), so that all enter
    ``on_segment``'s collectives together; ``n_registered`` is rank 0's.
    """
    N = scene.kp_mask.shape[0]
    if segment <= 0 or segment >= N:
        scene, excluded, n_reg, _ = registration_sweep_step(
            scene, excluded, fp_tbl, generator, max_repr_error, min_tri_angle, **kw)
        scene, excluded, (n_reg,) = sync_ranks(mesh, scene, excluded, n_reg)
        return scene, excluded, n_reg
    total = 0
    for _ in range(0, N + segment, segment):
        scene, excluded, n_reg, more = registration_sweep_step(
            scene, excluded, fp_tbl, generator, max_repr_error, min_tri_angle,
            max_steps=segment, **kw)
        scene, excluded, (n_reg, more) = sync_ranks(mesh, scene, excluded, n_reg, more)
        total += n_reg
        if not more:
            break
        if on_segment is not None:
            scene = on_segment(scene)
    return scene, excluded, total
