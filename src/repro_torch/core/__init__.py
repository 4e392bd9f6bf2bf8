"""Host copies of ``repro.core``: the FedLay overlay's coordinates,
topology, MEP weights, mixing schedules and the NDMP simulator.  Pure
numpy; each module says which file of the reference it copies."""
