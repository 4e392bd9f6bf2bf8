"""Copies of ``repro.core``: the FedLay overlay's coordinates, topology,
MEP weights, mixing schedules, the NDMP simulator, the baseline overlays
and their metrics (pure numpy), and the DFL engine (:mod:`.dfl`), whose
client models live on the device.  Each module says which file of the
reference it copies."""
