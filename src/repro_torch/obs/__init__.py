"""Telemetry bus and per-round ledger: copies of ``repro.obs.events``
and ``repro.obs.rounds`` (pure Python)."""
