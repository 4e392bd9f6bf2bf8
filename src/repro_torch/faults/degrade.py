"""Graceful-degradation machinery: backoff, health lifecycle, repair policy.

A copy of ``repro/faults/degrade.py``.

NDMP repair under faults is *bounded, not assumed*: the overlay
controller retries repair waits under a decorrelated-jitter
:class:`BackoffPolicy` at most ``RepairPolicy.max_retries`` times and
then gives up loudly instead of spinning.  Node health moves through a
**versioned** healthy → suspect → evicted (→ healed) lifecycle in
:class:`HealthTracker`; versioning makes a stale heal (one observed
against an older incarnation) a no-op, so an evicted node can never be
resurrected out of order.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, FrozenSet, Optional

import numpy as np

from ..obs import get_telemetry

__all__ = ["BackoffPolicy", "HealthState", "HealthTracker", "RepairPolicy"]


@dataclasses.dataclass
class BackoffPolicy:
    """Decorrelated-jitter backoff (AWS architecture-blog variant).

    Each delay is ``min(cap, uniform(base, prev * 3))`` — jittered so
    concurrent repairers don't thundering-herd the same neighbors,
    growing roughly geometrically, capped at ``cap`` seconds.  Seeded,
    so a fault storm replays bit-identically.
    """
    base: float = 0.5
    cap: float = 8.0
    seed: int = 0

    def __post_init__(self):
        if self.base <= 0 or self.cap < self.base:
            raise ValueError("need 0 < base <= cap")
        self._rng = np.random.default_rng(self.seed)
        self._prev = self.base

    def reset(self) -> None:
        self._prev = self.base
        self._rng = np.random.default_rng(self.seed)

    def next_delay(self) -> float:
        self._prev = min(self.cap,
                         float(self._rng.uniform(self.base, self._prev * 3.0)))
        return self._prev


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    EVICTED = "evicted"


@dataclasses.dataclass
class _NodeHealth:
    state: HealthState = HealthState.HEALTHY
    version: int = 0          # bumps on every transition
    since: float = 0.0        # sim time of last transition


class HealthTracker:
    """Versioned suspect → evict → heal lifecycle for data-plane peers.

    ``suspect(node, t)`` marks a node unresponsive; after
    ``suspect_grace`` seconds without a heal it is **evicted** (all its
    data-plane edges masked until it heals).  ``heal(node, version)``
    must quote the version at which the caller observed the node
    suspect/evicted — a stale version is rejected, so a delayed "it's
    fine" from before a newer eviction cannot resurrect the node.
    Transitions land on the bus as ``faults.suspects`` /
    ``faults.evictions`` / ``faults.heals``.
    """

    def __init__(self, suspect_grace: float = 2.0):
        self.suspect_grace = float(suspect_grace)
        self._nodes: Dict[int, _NodeHealth] = {}

    def _get(self, node: int) -> _NodeHealth:
        return self._nodes.setdefault(node, _NodeHealth())

    def state_of(self, node: int) -> HealthState:
        return self._get(node).state

    def version_of(self, node: int) -> int:
        return self._get(node).version

    def suspect(self, node: int, now: float) -> int:
        """Mark ``node`` unresponsive; returns the new version."""
        h = self._get(node)
        if h.state is HealthState.HEALTHY:
            h.state = HealthState.SUSPECT
            h.version += 1
            h.since = now
            get_telemetry().count("faults.suspects")
        return h.version

    def heal(self, node: int, version: int, now: float = 0.0) -> bool:
        """Clear a suspicion/eviction observed at ``version``.

        Returns False (no-op) when ``version`` is stale — a newer
        transition superseded the observation behind this heal.
        """
        h = self._get(node)
        if h.state is HealthState.HEALTHY:
            return False
        if version < h.version:
            return False
        h.state = HealthState.HEALTHY
        h.version += 1
        h.since = now
        get_telemetry().count("faults.heals")
        return True

    def poll(self, now: float) -> None:
        """Advance suspects past their grace window to EVICTED."""
        for h in self._nodes.values():
            if (h.state is HealthState.SUSPECT
                    and now - h.since >= self.suspect_grace):
                h.state = HealthState.EVICTED
                h.version += 1
                h.since = now
                get_telemetry().count("faults.evictions")

    def unhealthy(self) -> FrozenSet[int]:
        """Nodes whose data-plane edges should be masked this round."""
        return frozenset(n for n, h in self._nodes.items()
                         if h.state is not HealthState.HEALTHY)

    def evicted(self) -> FrozenSet[int]:
        return frozenset(n for n, h in self._nodes.items()
                         if h.state is HealthState.EVICTED)


@dataclasses.dataclass
class RepairPolicy:
    """Bounded NDMP-repair retry policy for the overlay controller.

    After each control window the controller checks
    ``sim.correctness()``; below ``correctness_target`` it advances the
    simulator by a backoff delay (giving repair traffic time to land)
    and rechecks, at most ``max_retries`` times.  Recovery increments
    ``faults.repair_recovered``; exhaustion increments
    ``faults.repair_gave_up`` and the round proceeds degraded rather
    than blocking forever.
    """
    correctness_target: float = 1.0
    max_retries: int = 4
    backoff: Optional[BackoffPolicy] = None

    def __post_init__(self):
        if self.backoff is None:
            self.backoff = BackoffPolicy()
