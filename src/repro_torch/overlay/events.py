"""Churn event streams and neighbor-table deltas (paper §III-B, Figs 8/18).

A copy of ``repro/overlay/events.py``.  Two host-side primitives the
control plane is built from:

* :class:`ChurnTrace` — a time-ordered stream of join/leave/fail events,
  either scripted (benchmark reproductions) or stochastic (Poisson
  arrivals/departures, the paper's sustained-churn setting), applied to
  a :class:`repro_torch.core.ndmp.Simulator` as simulated time advances.
* :class:`DeltaTracker` — the neighbor-table delta extractor: it polls
  :meth:`Simulator.neighbor_tables` between control steps (guarded by
  the cheap :meth:`Simulator.tables_version` stamp) and reports what
  changed as an epoch-stamped :class:`TableDelta`.

Neither touches device state; :mod:`repro_torch.overlay.controller` turns the
deltas into rebuilt mixers.

Churn-window cursor semantics
-----------------------------
The controller consumes a trace through an **applied-window cursor**:
each ``OverlayController.step(dt, trace=...)`` takes the events in the
half-open window ``(applied_until, now + dt]`` and advances
``applied_until`` to ``now + dt``.  Two consequences worth knowing:

* the cursor starts at ``-inf``, so events stamped at or before the
  first window's start — e.g. a ``t=0`` mass-churn prologue — fire on
  the *first* ``step()`` instead of silently falling outside the
  window;
* the cursor advances **whether or not a trace was passed**, so a trace
  must be supplied on *every* ``step()`` that should observe it.
  Handing the controller a trace after stepping past its event times
  (or only on some steps) silently skips the past-time events — they
  are never retroactively applied.  Benchmarks that need to sample
  state "right after injection" use a ``dt=0`` priming step.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.ndmp import SimulatorProtocol


# --------------------------------------------------------------------------
# Churn events
# --------------------------------------------------------------------------

EVENT_KINDS = ("join", "leave", "fail")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One membership change at simulated time ``time``.

    ``bootstrap`` (joins only) names the existing node the joiner enters
    through; None means "pick any live node at apply time", which is the
    paper's minimum assumption of one live contact.
    """

    time: float
    kind: str                       # "join" | "leave" | "fail"
    node_id: int
    bootstrap: Optional[int] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown churn event kind {self.kind!r}; "
                f"choose from {EVENT_KINDS}")


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """A time-sorted churn schedule, applied against a live simulator."""

    events: Tuple[ChurnEvent, ...]

    def __post_init__(self):
        ordered = tuple(sorted(self.events, key=lambda e: (e.time, e.node_id)))
        object.__setattr__(self, "events", ordered)
        object.__setattr__(self, "_times", [e.time for e in ordered])

    @property
    def horizon(self) -> float:
        return self.events[-1].time if self.events else 0.0

    def between(self, t0: float, t1: float) -> Tuple[ChurnEvent, ...]:
        """Events with time in the half-open window (t0, t1]."""
        lo = bisect.bisect_right(self._times, t0)
        hi = bisect.bisect_right(self._times, t1)
        return self.events[lo:hi]

    @staticmethod
    def apply(sim: SimulatorProtocol, events: Iterable[ChurnEvent]) -> None:
        """Apply ``events`` to ``sim`` at their scheduled times (the
        simulator is advanced to each event's timestamp first, so the
        NDMP message interleaving is exact)."""
        for ev in events:
            sim.run_until(max(sim.now, ev.time))
            if ev.kind == "join":
                boot = ev.bootstrap
                alive = sim.alive_ids()
                if boot is None or boot not in alive:
                    if not alive:
                        raise RuntimeError(
                            f"join of {ev.node_id} at t={ev.time}: "
                            f"no live bootstrap node")
                    boot = alive[ev.node_id % len(alive)]
                sim.join(ev.node_id, bootstrap=boot,
                         seeds=tuple(alive[:3]))
            elif ev.kind == "leave":
                sim.leave(ev.node_id)
            else:
                sim.fail(ev.node_id)

    # ---- constructors ----------------------------------------------------
    @classmethod
    def scripted(cls, events: Sequence[Tuple[float, str, int]]) -> "ChurnTrace":
        """From ``(time, kind, node_id)`` triples (or 4-tuples with a
        bootstrap for joins)."""
        out = []
        for ev in events:
            if len(ev) == 3:
                t, kind, node = ev
                out.append(ChurnEvent(time=float(t), kind=kind,
                                      node_id=int(node)))
            else:
                t, kind, node, boot = ev
                out.append(ChurnEvent(time=float(t), kind=kind,
                                      node_id=int(node),
                                      bootstrap=int(boot)))
        return cls(events=tuple(out))

    @classmethod
    def stochastic(cls, *, horizon: float, join_rate: float = 0.0,
                   fail_rate: float = 0.0, leave_rate: float = 0.0,
                   initial_ids: Sequence[int] = (), first_new_id: int = 10_000,
                   min_alive: int = 2, seed: int = 0) -> "ChurnTrace":
        """Poisson churn: exponential inter-arrival times per event kind,
        departures drawn uniformly from the nodes alive at that instant
        (never dropping below ``min_alive``)."""
        rng = np.random.default_rng(seed)
        proposals: List[Tuple[float, str]] = []
        for kind, rate in (("join", join_rate), ("fail", fail_rate),
                           ("leave", leave_rate)):
            if rate <= 0.0:
                continue
            t = float(rng.exponential(1.0 / rate))
            while t <= horizon:
                proposals.append((t, kind))
                t += float(rng.exponential(1.0 / rate))
        proposals.sort()
        alive = sorted(int(i) for i in initial_ids)
        next_id = first_new_id
        events: List[ChurnEvent] = []
        for t, kind in proposals:
            if kind == "join":
                events.append(ChurnEvent(time=t, kind="join", node_id=next_id))
                alive.append(next_id)
                next_id += 1
            elif len(alive) > min_alive:
                victim = alive.pop(int(rng.integers(len(alive))))
                events.append(ChurnEvent(time=t, kind=kind, node_id=victim))
        return cls(events=tuple(events))


# --------------------------------------------------------------------------
# Neighbor-table deltas
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TableDelta:
    """What changed in the live neighbor tables between two polls.

    ``epoch`` increases by one per poll *that observed a change*;
    quiescent polls return the previous epoch with ``empty`` True.
    ``changed`` maps surviving nodes whose neighbor set differs to their
    (old, new) sets.
    """

    epoch: int
    time: float
    joined: FrozenSet[int]
    left: FrozenSet[int]
    changed: Dict[int, Tuple[FrozenSet[int], FrozenSet[int]]]

    @property
    def empty(self) -> bool:
        return not (self.joined or self.left or self.changed)

    @property
    def num_affected(self) -> int:
        return len(self.joined) + len(self.left) + len(self.changed)


class DeltaTracker:
    """Epoch-stamped neighbor-table diffing on top of a Simulator.

    ``poll()`` is designed to be called once per control step: O(n)
    version check when nothing moved, full table diff otherwise.
    """

    def __init__(self, sim: SimulatorProtocol):
        self.sim = sim
        self.epoch = 0
        self._version = sim.tables_version()
        self._tables = sim.neighbor_tables()

    @property
    def tables(self) -> Dict[int, frozenset]:
        """The table snapshot as of the last poll."""
        return self._tables

    def poll(self) -> TableDelta:
        version = self.sim.tables_version()
        if version == self._version:
            return TableDelta(epoch=self.epoch, time=self.sim.now,
                              joined=frozenset(), left=frozenset(),
                              changed={})
        new = self.sim.neighbor_tables()
        old = self._tables
        joined = frozenset(new) - frozenset(old)
        left = frozenset(old) - frozenset(new)
        changed = {u: (old[u], new[u])
                   for u in frozenset(old) & frozenset(new)
                   if old[u] != new[u]}
        self._version = version
        self._tables = new
        if joined or left or changed:
            self.epoch += 1
        return TableDelta(epoch=self.epoch, time=self.sim.now,
                          joined=joined, left=left, changed=changed)
