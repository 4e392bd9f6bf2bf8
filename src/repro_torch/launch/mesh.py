"""The client process group: the port's one-axis DFL mesh.

The counterpart of ``repro/launch/mesh.py`` for the per-rank mixer
(:func:`repro_torch.dist.sync.make_mixer`).  Where the reference lays a
``jax.sharding.Mesh`` over devices, the port runs one process per rank
of a ``torch.distributed`` process group, and the group's ranks form the
client axis: rank r holds clients r·G … (r+1)·G − 1 (the grouped layout
of :mod:`repro_torch.dist.sync`).  The reference's production meshes
(``data`` × ``model``, the multi-pod ``pod`` axis) have no counterpart
yet: the port shards no model.

Nothing here runs when the module is imported; a process joins the group
with :func:`make_client_mesh` (an explicit rendezvous, or ``torchrun``'s
``env://``) and leaves it with :meth:`ClientMesh.close`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import ClassVar, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the one-axis client mesh: the process group,
    this process's rank in it, the group's size and the device the rank
    computes on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    #: The mesh's one axis, the clients'.
    axis_names: ClassVar[Tuple[str, ...]] = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        dist.destroy_process_group(self.group)


def make_client_mesh(rank: Optional[int] = None, world_size: Optional[int] = None,
                     init_method: str = "env://", *, device="cuda",
                     timeout_s: float = 600.0) -> ClientMesh:
    """Join the client process group as ``rank`` of ``world_size`` and
    return its mesh.  ``init_method`` is the rendezvous, the same for
    every rank: ``tcp://host:port`` or ``file:///path`` with an explicit
    ``rank`` and ``world_size``, or ``env://`` (the default), where
    ``torchrun``'s environment gives them (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; a ``rank`` or ``world_size``
    passed in wins).

    On ``cuda`` (the default) the group runs NCCL with one rank per card:
    the process takes the card of its local rank (``LOCAL_RANK`` under
    ``torchrun``, else its rank), and a world with more ranks on this
    host than the host has cards raises, since two ranks cannot share a
    card under NCCL.  On ``device="cpu"`` it runs gloo.  Asking for CUDA
    where there is none raises, as :func:`repro_torch.resolve_device`
    does.  ``timeout_s`` bounds every collective and exchange of the
    group.

    The group runs one all-reduce before it is returned: NCCL builds its
    communicator in the first collective call, which must include every
    rank, and the mixer's first exchange may be a batch of sends and
    receives in which some ranks take no part."""
    device = resolve_device(device)
    if rank is None or world_size is None:
        if init_method != "env://":
            raise ValueError(f"rendezvous {init_method!r} needs an explicit rank "
                             f"and world_size (only env:// reads them)")
        try:
            rank = int(os.environ["RANK"]) if rank is None else rank
            world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                          else world_size)
        except KeyError as err:
            raise RuntimeError(f"env:// rendezvous: {err.args[0]} is not set "
                               f"(launch with torchrun, or pass rank and "
                               f"world_size)") from None
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_world > cards or local_rank >= cards:
            raise RuntimeError(
                f"a CUDA client group of {local_world} ranks on this host needs "
                f"{local_world} cards, and the host has {cards}: NCCL takes one "
                f"rank per card, and two ranks cannot share one")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    group = dist.group.WORLD
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe, group=group)
    if probe.item() != world_size:
        raise RuntimeError(f"the first all-reduce of the client group gave "
                           f"{probe.item()}, not {world_size}")
    return ClientMesh(group=group, rank=rank, size=world_size, device=device)


def data_axes(mesh: ClientMesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh: its one client axis."""
    return mesh.axis_names


def num_clients(mesh: ClientMesh) -> int:
    """The size of the client axis: one client a rank (the reference's
    rule; :func:`repro_torch.dist.sharding.dfl_client_count` counts G a
    rank)."""
    return mesh.size
