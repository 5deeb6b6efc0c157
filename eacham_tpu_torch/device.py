"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card. Asking for CUDA without a card raises: an entry
    point never falls back to the CPU on its own — the CPU runs only when
    the caller asks for it (``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None):
    """numpy array or tensor -> tensor on ``device`` (no copy if already there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    """tensor (on any device) or array-like -> numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
