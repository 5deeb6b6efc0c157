"""CUDA-graph replay of fixed-shape stages: the port's one graph cache.

A stage is a function of named tensors, ``stage(inputs, **options) ->
dict``, whose kernels and shapes follow its inputs' shapes and its options
alone, and which reads nothing back to the host (no ``.item()``, ``int()``,
0-d device index or host scalar written into a device tensor: a capture
fails on it). ``staged(stage, inputs, counter, **options)`` runs one:

  * on a CUDA card, through ``CACHE``, keyed by the device (the first
    input's), the thread (a graph's static buffers serve one thread), the
    stage's name, every input's name, shape and dtype, and the options. A
    key's first use runs the stage eagerly, its second captures it
    (``cuda_capture``, after the card has caught up: a host wait once a
    capture) and runs the capture, later uses replay it. The cache keeps
    the 8 most recently used keys for the whole process, so a request
    replays the graphs of the one before it;
  * elsewhere (the CPU), eagerly.

A captured stage (``StageGraph``) holds static copies of its inputs. A call
copies in each input that is not the tensor last copied, or was written in
place since (its ``_version`` moved; inference tensors keep no count and
are copied on every call), replays, and returns copies of the outputs, so
that nothing returned aliases the graph's buffers.

Each capture and each replay is counted on the innermost ``utils.timer``
span as ``<counter>_captures`` / ``<counter>_replays``: ``graph_*`` for the
registration sweep's stages (``sfm.device_loop``: PnP, ``set_pose`` with the
first triangulation pass, the second pass), ``lm_graph_*`` for the dense
bundle adjustment's LM iteration (``ba.core._lm_iteration``, one graph a
problem size, replayed in every iteration of every window of that size).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from functools import partial

import torch

from eacham_tpu_torch.utils import timer


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
CACHE = GraphCache()


def graphable(dev: torch.device) -> bool:
    """Whether stages on ``dev`` run as graphs (a CUDA card)."""
    return dev.type == "cuda"


def staged(stage, inputs: dict, counter: str = "graph", **options) -> dict:
    """``stage(inputs, **options)``: through ``CACHE`` on a CUDA card, its
    captures and replays counted under ``counter``; eagerly elsewhere (see
    the module's docstring for the key)."""
    dev = next(iter(inputs.values())).device
    if not graphable(dev):
        return stage(inputs, **options)
    key = (dev, threading.get_ident(), stage.__name__,
           tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()),
           tuple(sorted(options.items())))
    return CACHE.run(key, partial(stage, **options), inputs, counter)
