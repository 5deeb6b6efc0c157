"""Wall-clock stage timing with accumulated statistics (port of
eacham_tpu/utils/timer.py).

Equivalent of the reference's BlockTimer RAII timer + static accumulation
(modules/base/tools/BlockTimer.cpp:10-47). It measures host-visible stage
latency: a stage on the card is timed to its end only where the stage
ends in a read back to the host (the CLI's stages do) or a
``torch.cuda.synchronize()``. For kernel times use CUDA events or
``torch.profiler``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_STATS: dict[str, list[float]] = defaultdict(list)


@contextmanager
def BlockTimer(caption: str, accumulate: bool = True, verbose: bool = False):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        if accumulate:
            _STATS[caption].append(ms)
        if verbose:
            print(f"[{caption}] time: {ms:.2f} ms", flush=True)


def print_stats() -> None:
    """Count + mean per caption (BlockTimer::PrintStat, BlockTimer.cpp:38-47)."""
    for caption, xs in _STATS.items():
        print(
            f"[{caption}] count: {len(xs)}, mean: {sum(xs) / len(xs):.2f} ms",
            flush=True,
        )


def stats() -> dict[str, list[float]]:
    """Milliseconds recorded per caption since the last ``reset_stats``."""
    return {caption: list(xs) for caption, xs in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()
