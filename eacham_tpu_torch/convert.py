"""Carry SfM state across the two packages as numpy arrays.

``scene_from_numpy`` takes a reference ``Scene`` given as a dict of numpy
arrays (``{k: np.asarray(v) for k, v in scene._asdict().items()}``) and
builds the port's ``Scene``; ``scene_to_numpy`` is the reverse. This path
has no learned weights; the converter for the deep frontend's weights
comes with that frontend.
"""

from __future__ import annotations

import numpy as np
import torch

from eacham_tpu_torch.sfm.scene import Scene


def scene_from_numpy(d, device: str | torch.device = "cpu") -> Scene:
    """dict (or NamedTuple) of array-likes with the ``Scene`` fields -> Scene."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    return Scene(**{f: torch.as_tensor(np.array(d[f]), device=device)
                    for f in Scene._fields})


def scene_to_numpy(scene: Scene) -> dict:
    """Scene -> dict of numpy arrays keyed by field name."""
    return {f: getattr(scene, f).detach().cpu().numpy() for f in Scene._fields}
