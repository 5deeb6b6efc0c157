"""Device-level profiling hooks (port of eacham_tpu/utils/profiling.py).

Complements the host-side ``BlockTimer`` (utils/timer.py) with a
``torch.profiler`` trace of the host and the card, viewable in Perfetto
(ui.perfetto.dev) or chrome://tracing, and a device-memory summary.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from pathlib import Path

import torch


@contextmanager
def device_trace(logdir: str | os.PathLike = "eacham_trace"):
    """Trace everything inside the block, host and (where there is one)
    card, and write it as a Chrome/Perfetto JSON trace into ``logdir``
    (``trace-<pid>.json``) when the block ends. Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield str(out)
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}.json"))


def memory_summary() -> str:
    """One line per visible card: bytes allocated by this process, and the
    card's free and total memory. Without a card, one line that says the
    stats are unavailable."""
    if not torch.cuda.is_available():
        return "cpu: memory stats unavailable (no CUDA device)"
    lines = []
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        try:
            free, total = torch.cuda.mem_get_info(i)
        except RuntimeError:
            lines.append(f"cuda:{i} ({name}): memory stats unavailable")
            continue
        used = torch.cuda.memory_allocated(i)
        lines.append(f"cuda:{i} ({name}): {used / 2**20:.1f} MiB allocated, "
                     f"{(total - free) / 2**20:.0f} MiB in use / {total / 2**20:.0f} MiB")
    return "\n".join(lines)
