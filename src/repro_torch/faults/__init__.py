"""Data-plane fault snapshots of the port (counterpart of
``repro.faults``; only what the slot runtime needs so far)."""
