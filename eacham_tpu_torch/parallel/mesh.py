"""Process groups in place of device meshes (port of
eacham_tpu/parallel/mesh.py).

The JAX package drives every chip from one process through a
``jax.sharding.Mesh``. The PyTorch counterpart is one process per device,
launched together (``torchrun --nproc-per-node N``): every rank runs the
same pipeline on its own card, and the two sharded stages (the pair
matcher and the global BA) meet in ``torch.distributed`` collectives over
the ranks' process group, NCCL between cards and gloo between CPU
processes. ``Mesh`` carries that group with the reference's names: axis
names and a shape whose product is the number of ranks.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from eacham_tpu_torch.device import resolve_device

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class Mesh:
    """The ranks of a process group laid out along named axes. ``group`` is
    None when the mesh is this one process alone (no process group)."""

    group: object | None            # torch.distributed ProcessGroup
    world_size: int
    rank: int
    device: torch.device            # this rank's device
    axis_names: tuple[str, ...]
    shape: dict[str, int]           # axis name -> ranks along it


def _launch_hint(n: int) -> str:
    return (f"launch one process per device, e.g. `torchrun --nproc-per-node {n} "
            "<script>`, and call parallel.init_distributed() in each")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = "cuda",
) -> bool:
    """Join this process to the run's process group (idempotent).

    The address is ``host:port``, a ``tcp://`` or ``file://`` URL; without
    arguments the standard ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` variables (what ``torchrun`` sets) are read
    (an address alone: one process, rank 0). With neither it is a no-op
    returning False. The backend is NCCL on the card (this rank's card is
    ``LOCAL_RANK``, else the rank modulo the card count) and gloo when
    ``device="cpu"``.

    Returns True if more than one process is in the group.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    from_env = all(k in os.environ for k in _ENV)
    if coordinator_address is None and num_processes is None and not from_env:
        return False
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dist.get_world_size() > 1


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_mesh(device: str | torch.device, axis: str = "shard") -> Mesh:
    """This process alone, whatever group it belongs to: the sharded calls
    on it are the unsharded ones, with the same bits."""
    return Mesh(None, 1, 0, torch.device(device), (axis,), {axis: 1})


def _mesh(shape: dict[str, int], device) -> Mesh:
    n = math.prod(shape.values())
    dev = _rank_device(device)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} devices needs a process group of {n} ranks, "
                             f"and none is initialized: {_launch_hint(n)}")
        return Mesh(None, 1, 0, dev, tuple(shape), dict(shape))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {n} devices needs a process group of {n} ranks, "
                         f"this one has {world}: {_launch_hint(n)}")
    return Mesh(dist.group.WORLD, world, dist.get_rank(), dev, tuple(shape), dict(shape))


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              device: str | torch.device | None = "cuda") -> Mesh:
    """1-D mesh over the ranks of the initialized process group (default:
    all of them; this process alone if there is none). ``n_devices``
    unequal to the group's size raises a ValueError that says how to
    launch."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh({axis: n_devices}, device)


def make_mesh_2d(n_hosts: int | None = None, chips_per_host: int | None = None,
                 axes: tuple[str, str] = ("dcn", "ici"),
                 device: str | torch.device | None = "cuda") -> Mesh:
    """(hosts, chips) mesh over the ranks of the process group. Consumers
    shard over both axes flattened, so the per-rank work equals a 1-D
    mesh's. Defaults: chips = ``LOCAL_WORLD_SIZE`` (else every rank),
    hosts = ranks / chips."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if chips_per_host is None:
        chips_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_hosts is None:
        n_hosts = max(1, world // max(chips_per_host, 1))
    return _mesh({axes[0]: n_hosts, axes[1]: chips_per_host}, device)


def mesh_axes(mesh: Mesh) -> tuple[tuple[str, ...], int]:
    """(axis-name tuple, total device count): consumers shard their leading
    data axis over all mesh axes flattened, so 1-D and (hosts, chips)
    meshes shard alike."""
    return tuple(mesh.axis_names), math.prod(mesh.shape[a] for a in mesh.axis_names)


def shard_rows(n: int, mesh: Mesh) -> tuple[int, int, int]:
    """(padding, first row, last row + 1) of this rank's contiguous block
    of an axis of ``n`` rows padded to a multiple of the mesh's size."""
    _, n_dev = mesh_axes(mesh)
    pad = (-n) % n_dev
    per = (n + pad) // n_dev
    return pad, mesh.rank * per, (mesh.rank + 1) * per
