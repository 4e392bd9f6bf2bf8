"""The distribution layer of the port (counterpart of ``repro.dist``):

* :mod:`repro_torch.dist.sharding` — the client count of a mesh (the
  reference's PartitionSpec rules wait for the training front door);
* :mod:`repro_torch.dist.flat` — :class:`~repro_torch.dist.flat.FlatSpec`,
  the flat-buffer layout of the fused mixing round;
* :mod:`repro_torch.dist.sync` — the FedLay overlay turned into mixing
  rounds: the global-view :func:`global_mixer` and the per-rank
  :func:`fedlay_mix` / :func:`make_mixer` over a process group, the
  allreduce / ring / none baselines, and the paper's per-client
  communication accounting.

The client process group itself is made by
:func:`repro_torch.launch.mesh.make_client_mesh` (the reference keeps its
``make_client_mesh`` in ``repro.dist.compat``).
"""

from . import flat, sharding, sync
from ..launch.mesh import make_client_mesh
from .flat import FlatSpec
from .sharding import dfl_client_count
from .sync import (FUSE_MODES, check_fuse, fedlay_mix, global_mixer,
                   make_mixer, ring_schedule, sync_bytes_per_client)

__all__ = [
    "flat", "sharding", "sync",
    "make_client_mesh",
    "FlatSpec",
    "dfl_client_count",
    "FUSE_MODES", "check_fuse",
    "fedlay_mix", "global_mixer", "make_mixer", "ring_schedule",
    "sync_bytes_per_client",
]
