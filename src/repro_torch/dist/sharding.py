"""Sharding rules of the DFL client axis.

The counterpart of ``repro/dist/sharding.py``, in part: the client count
of a mesh.  The reference's PartitionSpec rules (``param_specs``,
``cache_specs``, ``batch_spec``, ``spec_for_leaf``,
``enforce_divisibility``) stay unported: the port's training front door
(``launch/train.py``) shards no model, each rank holding its G clients'
full replicas.  They wait for the port's dry run (ROADMAP.md Queue 1
item 11), their first caller.
"""

from __future__ import annotations


def dfl_client_count(mesh, clients_per_device: int = 1) -> int:
    """Total DFL clients a mesh hosts: ``G · Π(non-model axis sizes)``.

    ``mesh`` is a :class:`repro_torch.launch.mesh.ClientMesh` (anything
    with ``axis_names`` and a ``shape`` mapping).  The client axis of a
    DFL run is sized by this rule, so the grouped layout of
    :func:`repro_torch.dist.sync.fedlay_mix` — client i on rank i // G —
    holds exactly G clients a rank."""
    if clients_per_device < 1:
        raise ValueError("clients_per_device must be >= 1")
    n = clients_per_device
    for a in mesh.axis_names:
        if a != "model":
            n *= mesh.shape[a]
    return n
