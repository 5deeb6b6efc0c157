"""Carry SfM state and learned weights across the two packages as numpy
arrays.

``scene_from_numpy`` takes a reference ``Scene`` given as a dict of numpy
arrays (``{k: np.asarray(v) for k, v in scene._asdict().items()}``) and
builds the port's ``Scene``; ``scene_to_numpy`` is the reverse.
``ba_problem_from_numpy`` / ``ba_problem_to_numpy`` do the same for a
``BAProblem`` (index arrays become int64, absent anchors stay None).

``superpoint_from_numpy`` and ``lightglue_from_numpy`` build the deep
frontend's modules from a flat dict of numpy arrays keyed as the
reference's ``lightglue.save_params`` writes them
(``"['params']/['backbone']/['c1a']/['kernel']"``, ...): ``np.load`` of a
shipped ``.npz`` and a flattened parameter tree of the reference both go
in. Convolution kernels move from [kh, kw, in, out] to [out, in, kh, kw],
dense kernels from [in, out] to [out, in]; values are cast to fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from eacham_tpu_torch.ba.core import BAProblem
from eacham_tpu_torch.device import resolve_device
from eacham_tpu_torch.features.deep.lightglue import AttentionBlock, LightGlueMatcher
from eacham_tpu_torch.features.deep.superpoint import SuperPointNet
from eacham_tpu_torch.sfm.scene import Scene


def scene_from_numpy(d, device: str | torch.device | None = None) -> Scene:
    """dict (or NamedTuple) of array-likes with the ``Scene`` fields -> Scene
    on ``device``: the card by default (an error without one), the CPU only
    when asked (``device="cpu"``)."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    dev = resolve_device(device)
    return Scene(**{f: torch.as_tensor(np.array(d[f]), device=dev)
                    for f in Scene._fields})


def scene_to_numpy(scene: Scene) -> dict:
    """Scene -> dict of numpy arrays keyed by field name."""
    return {f: getattr(scene, f).detach().cpu().numpy() for f in Scene._fields}


def ba_problem_from_numpy(d, device: str | torch.device | None = None) -> BAProblem:
    """dict (or NamedTuple) of array-likes with the ``BAProblem`` fields ->
    BAProblem on ``device`` (resolved as in ``scene_from_numpy``)."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    dev = resolve_device(device)
    out = {}
    for f in BAProblem._fields:
        v = d.get(f)
        if v is None:
            out[f] = None
            continue
        t = torch.as_tensor(np.array(v), device=dev)
        out[f] = t.long() if f in ("obs_cam", "obs_pt") else t
    return BAProblem(**out)


def ba_problem_to_numpy(p: BAProblem) -> dict:
    """BAProblem -> dict of numpy arrays keyed by field name (None kept)."""
    return {f: None if getattr(p, f) is None else getattr(p, f).detach().cpu().numpy()
            for f in BAProblem._fields}


def _key(*names: str) -> str:
    return "/".join(f"['{n}']" for n in ("params", *names))


def _take(flat, used: set, *names: str) -> torch.Tensor:
    key = _key(*names)
    if key not in flat:
        raise KeyError(f"weights lack {key}")
    used.add(key)
    return torch.as_tensor(np.array(flat[key], dtype=np.float32))


def _load_conv(conv: torch.nn.Conv2d, flat, used, *path: str) -> None:
    kernel = _take(flat, used, *path, "kernel").permute(3, 2, 0, 1)
    _assign(conv.weight, kernel, path)
    _assign(conv.bias, _take(flat, used, *path, "bias"), path)


def _load_dense(lin: torch.nn.Linear, flat, used, *path: str) -> None:
    _assign(lin.weight, _take(flat, used, *path, "kernel").t(), path)
    _assign(lin.bias, _take(flat, used, *path, "bias"), path)


def _load_norm(ln: torch.nn.LayerNorm, flat, used, *path: str) -> None:
    _assign(ln.weight, _take(flat, used, *path, "scale"), path)
    _assign(ln.bias, _take(flat, used, *path, "bias"), path)


def _assign(param: torch.nn.Parameter, value: torch.Tensor, path) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{'/'.join(path)}: the weights have shape {tuple(value.shape)}, "
                         f"the module wants {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _require_all_used(flat, used: set, what: str) -> None:
    extra = sorted(set(flat.keys()) - used)
    if extra:
        raise ValueError(f"{what}: {len(extra)} arrays of the weights have no place "
                         f"in the module, e.g. {extra[0]}")


def superpoint_from_numpy(flat) -> SuperPointNet:
    """Flat dict of the reference's SuperPointNet parameters -> module
    (on the CPU, in eval mode)."""
    net = SuperPointNet()
    used: set = set()
    for stage in ("c1", "c2", "c3", "c4"):
        for half in "ab":
            _load_conv(getattr(net.backbone, stage + half), flat, used, "backbone", stage + half)
    for name in ("det1", "det2", "desc1", "desc2"):
        _load_conv(getattr(net, name), flat, used, name)
    _require_all_used(flat, used, "superpoint")
    return net.eval()


def lightglue_from_numpy(flat, n_layers: int) -> LightGlueMatcher:
    """Flat dict of the reference's LightGlueMatcher parameters -> module
    with ``n_layers`` layers (on the CPU, in eval mode)."""
    net = LightGlueMatcher(n_layers=n_layers)
    used: set = set()
    for name, mod in net.named_children():
        if isinstance(mod, AttentionBlock):
            for sub in ("q", "k", "v", "proj", "mlp1", "mlp2"):
                _load_dense(getattr(mod, sub), flat, used, name, sub)
            for sub in ("ln_x", "ln_y", "ln_m"):
                _load_norm(getattr(mod, sub), flat, used, name, sub)
        else:
            _load_dense(mod, flat, used, name)
    _assign(net.desc_sim_gain, _take(flat, used, "desc_sim_gain"), ("desc_sim_gain",))
    _require_all_used(flat, used, "lightglue")
    return net.eval()
