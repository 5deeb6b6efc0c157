"""Scene checkpoint / resume (port of eacham_tpu/io/checkpoint.py).

The reference has no intermediate persistence at all — its only artifact
is the final transform.json (SURVEY.md §5 "Checkpoint / resume: none").
The whole reconstruction state (the ``Scene`` tensors, sfm/scene.py) is
one ``.npz``: one array per ``Scene`` field under the field's name, extra
arrays under ``extra_<name>``, written atomically. The layout and the
dtypes are the JAX package's, so a checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from eacham_tpu_torch.device import resolve_device, to_numpy
from eacham_tpu_torch.sfm.scene import Scene

_FIELDS = Scene._fields
# the reference's index fields are int32 (its scene builders and
# jnp.int32 arithmetic); a port tensor that came out int64 is written so
_INT32 = ("pair_idx", "match_ij", "match_ji", "n_landmarks", "kp2lm")


def save_scene(path: str | Path, scene: Scene, **extra_arrays) -> None:
    """Atomic write (tmp + rename): a process killed mid-save — the
    crash-resume workflow's whole point — must never leave a truncated
    checkpoint behind. Tensors on the card are copied to the host."""
    path = Path(path)
    data = {f: to_numpy(getattr(scene, f)) for f in _FIELDS}
    for f in _INT32:
        data[f] = data[f].astype(np.int32)
    for k, v in extra_arrays.items():
        data[f"extra_{k}"] = to_numpy(v)
    # .npz-suffixed tmp name: np.savez appends .npz to any other suffix,
    # and probing for the unsuffixed name could rename a STALE leftover
    # over the live checkpoint
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez_compressed(tmp, **data)
    tmp.replace(path)


def load_scene(path: str | Path, device: str | torch.device | None = "cuda"
               ) -> tuple[Scene, dict]:
    """(Scene on ``device``, {name: numpy array} of the extra arrays).
    The card by default; without one this raises unless ``device="cpu"``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        kw = {f: torch.as_tensor(np.array(data[f]), device=dev) for f in _FIELDS}
        extra = {
            k[len("extra_"):]: np.asarray(v)
            for k, v in data.items() if k.startswith("extra_")
        }
    return Scene(**kw), extra
