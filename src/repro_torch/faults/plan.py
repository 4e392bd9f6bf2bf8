"""Deterministic fault plans and the chaos engine that executes them.

A copy of ``repro/faults/plan.py``.

A :class:`FaultPlan` is a frozen, seed-reproducible description of
everything that goes wrong in a run; :class:`ChaosEngine` wraps either
NDMP engine behind the :class:`repro_torch.core.ndmp.SimulatorProtocol` seam
and injects the plan while delegating the normal protocol surface.
The same plan therefore drives the per-message object
:class:`~repro_torch.core.ndmp.Simulator` (exact transport faults) and the
flat-array :class:`~repro_torch.scale.ndmp_vec.VectorSimulator` (their
converged image) — see the package docstring for the equivalence
argument.

Data-plane faults (link outages, stragglers, active partitions) never
touch NDMP; they surface through :meth:`ChaosEngine.data_faults` as a
:class:`DataFaults` snapshot that :func:`edge_mask_for` lowers to the
``(C, 2L)`` unreachable-edge mask consumed by the masked mixers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import get_telemetry

__all__ = ["FaultPlan", "Partition", "LinkOutage", "Straggler",
           "DataFaults", "ChaosEngine", "edge_mask_for"]


# --------------------------------------------------------------------------
# plan vocabulary
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Partition:
    """A timed network partition over ``groups`` of node ids.

    During ``[start, end)`` cross-group control-plane messages are
    dropped.  ``symmetric=True`` severs both directions; with
    ``symmetric=False`` only traffic *from* ``groups[0]`` to the other
    groups is dropped (one-way outage).  Nodes not listed in any group
    are unaffected.  At ``end`` the chaos engine runs the heal-merge
    sweep (rejoin every non-anchor side through a cross-side
    bootstrap).  The vector engine models every partition
    symmetrically — the converged approximation.
    """
    start: float
    end: float
    groups: Tuple[Tuple[int, ...], ...]
    symmetric: bool = True

    def __post_init__(self):
        if self.end <= self.start:
            raise ValueError("partition end must be after start")
        if len(self.groups) < 2:
            raise ValueError("partition needs >= 2 groups")
        flat = [u for g in self.groups for u in g]
        if len(flat) != len(set(flat)):
            raise ValueError("partition groups overlap")

    def group_of(self, node: int) -> Optional[int]:
        for gi, g in enumerate(self.groups):
            if node in g:
                return gi
        return None


@dataclasses.dataclass(frozen=True)
class LinkOutage:
    """Data-plane outage of the undirected edge ``{a, b}`` over ``[start, end)``."""
    start: float
    end: float
    a: int
    b: int


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Node ``node`` is too slow to exchange models during ``[start, end)``.

    A straggler stays in the overlay (its heartbeats are fine); only
    its data-plane edges are masked, so every neighbor renormalizes
    away from it and the straggler keeps its own model for the round.
    """
    start: float
    end: float
    node: int


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Everything that will go wrong in a run, declared up front.

    Probabilities are per-message and independent; all randomness
    derives from ``seed`` (and the host simulator's own seeded RNG),
    so a plan replays bit-identically.

    * ``msg_loss`` — drop probability per NDMP message.
    * ``msg_delay`` / ``delay_factor`` — with probability ``msg_delay``
      a message takes ``delay_factor`` extra one-way latencies.
    * ``msg_dup`` — duplicate probability (at-least-once transport).
    * ``partitions`` — timed :class:`Partition` windows.
    * ``crashes`` — ``(time, node)`` crash-without-leave events.
    * ``rejoins`` — ``(time, node, bootstrap)`` scheduled re-entries:
      an alive node re-anchors (``rejoin``), a crashed one joins fresh.
    * ``link_outages`` / ``stragglers`` — data-plane faults, surfaced
      only through :meth:`ChaosEngine.data_faults`.
    """
    seed: int = 0
    msg_loss: float = 0.0
    msg_delay: float = 0.0
    delay_factor: float = 3.0
    msg_dup: float = 0.0
    partitions: Tuple[Partition, ...] = ()
    crashes: Tuple[Tuple[float, int], ...] = ()
    rejoins: Tuple[Tuple[float, int, int], ...] = ()
    link_outages: Tuple[LinkOutage, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()

    def __post_init__(self):
        for name in ("msg_loss", "msg_delay", "msg_dup"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"{name} must be in [0, 1)")

    @property
    def message_faults(self) -> bool:
        return bool(self.msg_loss or self.msg_delay or self.msg_dup)

    def delay_scale(self) -> float:
        """Converged-image deadline stretch for the vector engine.

        Loss forces ~1/(1-p) delivery attempts per message; delayed
        messages stretch the mean transit by ``1 + q*delay_factor``.
        Duplicates never slow anything down.
        """
        return (1.0 + self.msg_delay * self.delay_factor) / (1.0 - self.msg_loss)


# --------------------------------------------------------------------------
# data-plane snapshot → edge mask
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataFaults:
    """Data-plane faults active at one instant.

    ``down_pairs`` holds undirected ``(min, max)`` node-id pairs,
    ``slow_nodes`` the straggling node ids, and ``groups`` the groups
    of the active partition (``None`` when whole).  The data-plane
    mask is always symmetric — if either endpoint cannot complete the
    exchange, the edge is down for both (an asymmetric *control*
    partition still kills data exchange both ways: model exchange is a
    round trip).
    """
    down_pairs: FrozenSet[Tuple[int, int]] = frozenset()
    slow_nodes: FrozenSet[int] = frozenset()
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __bool__(self) -> bool:
        return bool(self.down_pairs or self.slow_nodes or self.groups)

    def edge_down(self, u: int, v: int) -> bool:
        if u == v:
            return False
        if u in self.slow_nodes or v in self.slow_nodes:
            return True
        if (min(u, v), max(u, v)) in self.down_pairs:
            return True
        if self.groups is not None:
            gu = gv = None
            for gi, g in enumerate(self.groups):
                if u in g:
                    gu = gi
                if v in g:
                    gv = gi
            if gu is not None and gv is not None and gu != gv:
                return True
        return False


def edge_mask_for(sched, slot_nodes: Sequence[Optional[int]],
                  faults: DataFaults) -> np.ndarray:
    """Lower a :class:`DataFaults` snapshot to a ``(C, 2L)`` edge mask.

    ``sched`` is a :class:`repro_torch.core.mixing.PermuteSchedule` (or any
    object with ``(K, C)`` ``perms``) in *slot* space; ``slot_nodes[i]``
    is the node id occupying slot ``i`` (``None`` for empty slots —
    their edges are left at 1, the alive mask already removes them).
    Entry ``[i, k]`` is 0 when the edge between slot ``i`` and its
    k-th incoming slot ``perms[k][i]`` is unreachable.  The mask is
    symmetric by construction because :meth:`DataFaults.edge_down` is.

    Feed the result to the masked mixers' keyword-only ``edge_mask`` —
    a runtime input on the existing weights path, so degraded rounds
    reuse the same MixerCache entry and reallocate nothing.
    """
    perms = np.asarray(getattr(sched, "perms", sched), dtype=np.int64)
    n = perms.shape[1]
    em = np.ones((n, perms.shape[0]), np.float32)
    if not faults:
        return em
    for i in range(n):
        u = slot_nodes[i]
        if u is None:
            continue
        for k in range(perms.shape[0]):
            v = slot_nodes[int(perms[k, i])]
            if v is None:
                continue
            if faults.edge_down(int(u), int(v)):
                em[i, k] = 0.0
    return em


# --------------------------------------------------------------------------
# chaos engine
# --------------------------------------------------------------------------

def _count(counts: Dict[str, int], name: str, n: int = 1) -> None:
    counts[name] = counts.get(name, 0) + n
    get_telemetry().count(f"faults.{name}", n)


class ChaosEngine:
    """SimulatorProtocol wrapper that executes a :class:`FaultPlan`.

    Wrap either engine::

        sim = ChaosEngine(Simulator(num_spaces=3, seed=0), plan)
        sim = ChaosEngine(VectorSimulator(num_spaces=3), plan)

    and hand the wrapper wherever a plain simulator goes (e.g.
    :class:`repro_torch.overlay.controller.OverlayController`).  Timed plan
    events (partition start/heal, crashes, rejoins) fire in order as
    simulated time passes through them; per-message faults apply via
    the object engine's transport filter, or as a single converged
    delay stretch on the vector engine.  All injections are tallied in
    ``self.counts`` and mirrored as ``faults.*`` bus counters.
    """

    def __init__(self, sim, plan: FaultPlan):
        self.sim = sim
        self.plan = plan
        self.num_spaces = sim.num_spaces
        self.counts: Dict[str, int] = {}
        self._rng = np.random.default_rng(plan.seed)
        self._active: List[Partition] = []
        # (time, seq, kind, payload) — seq keeps same-time events in
        # plan declaration order
        events: List[Tuple[float, int, str, object]] = []
        seq = 0
        for p in plan.partitions:
            events.append((p.start, seq, "partition_start", p)); seq += 1
            events.append((p.end, seq, "partition_heal", p)); seq += 1
        for t, node in plan.crashes:
            events.append((t, seq, "crash", node)); seq += 1
        for t, node, boot in plan.rejoins:
            events.append((t, seq, "rejoin", (node, boot))); seq += 1
        self._events = sorted(events)
        self._next_ev = 0
        self._vector = not hasattr(sim, "set_message_filter")
        if self._vector:
            if plan.message_faults:
                sim.set_delay_scale(plan.delay_scale())
        elif plan.message_faults or plan.partitions:
            sim.set_message_filter(self._filter)

    # ---- protocol surface -------------------------------------------------
    @property
    def now(self) -> float:
        return self.sim.now

    def run_until(self, t: float) -> None:
        while self._next_ev < len(self._events) and self._events[self._next_ev][0] <= t:
            when, _, kind, payload = self._events[self._next_ev]
            self._next_ev += 1
            self.sim.run_until(when)
            self._apply(kind, payload)
        self.sim.run_until(t)

    def advance(self, dt: float) -> None:
        self.run_until(self.sim.now + dt)

    def alive_ids(self):
        return self.sim.alive_ids()

    def alive_addresses(self):
        return self.sim.alive_addresses()

    def neighbor_tables(self):
        return self.sim.neighbor_tables()

    def tables_version(self):
        return self.sim.tables_version()

    def correctness(self) -> float:
        return self.sim.correctness()

    def join(self, node_id: int, bootstrap=None, **kw):
        return self.sim.join(node_id, bootstrap, **kw)

    def leave(self, node_id: int) -> None:
        self.sim.leave(node_id)

    def fail(self, node_id: int) -> None:
        self.sim.fail(node_id)

    def __getattr__(self, name):
        # everything else (seed_network, export_state, heartbeat_period,
        # …) passes straight through to the wrapped engine
        return getattr(self.sim, name)

    # ---- data-plane surface ----------------------------------------------
    def data_faults(self) -> DataFaults:
        """Data-plane faults active at ``sim.now`` (for the edge mask)."""
        t = self.sim.now
        down = frozenset(
            (min(o.a, o.b), max(o.a, o.b))
            for o in self.plan.link_outages if o.start <= t < o.end)
        slow = frozenset(
            s.node for s in self.plan.stragglers if s.start <= t < s.end)
        groups = self._active[-1].groups if self._active else None
        return DataFaults(down_pairs=down, slow_nodes=slow, groups=groups)

    # ---- plan event execution --------------------------------------------
    def _apply(self, kind: str, payload) -> None:
        if kind == "partition_start":
            self._active.append(payload)
            if self._vector:
                self.sim.set_partition([list(g) for g in payload.groups])
            _count(self.counts, "partition_starts")
        elif kind == "partition_heal":
            self._active = [p for p in self._active if p is not payload]
            if self._vector:
                self.sim.heal_partition()
            else:
                self._heal_merge(payload)
            _count(self.counts, "partition_heals")
        elif kind == "crash":
            if payload in set(self.sim.alive_ids()):
                self.sim.fail(payload)
                _count(self.counts, "crashes")
        elif kind == "rejoin":
            node, boot = payload
            if node in set(self.sim.alive_ids()):
                self.sim.rejoin(node, boot)
            else:
                self.sim.join(node, boot)
            _count(self.counts, "rejoins")

    def _heal_merge(self, p: Partition) -> None:
        """Merge the overlays a full partition left behind.

        Failure detection pruned each side down to an internally
        correct but disjoint overlay; probes alone never reconnect
        them.  Re-anchor every alive node of every non-anchor group
        through a bootstrap in the largest surviving group — Theorem 1
        splices each one back at its globally closest coordinates.
        """
        alive = set(self.sim.alive_ids())
        groups = [[u for u in g if u in alive] for g in p.groups]
        groups = [g for g in groups if g]
        if len(groups) < 2:
            return
        anchor = max(groups, key=len)
        boot = min(anchor)
        for g in groups:
            if g is anchor:
                continue
            for u in g:
                self.sim.rejoin(u, boot)
                _count(self.counts, "rejoins")

    # ---- object-engine transport filter ----------------------------------
    def _blocked(self, src: int, dst: int) -> bool:
        for p in self._active:
            gs, gd = p.group_of(src), p.group_of(dst)
            if gs is None or gd is None or gs == gd:
                continue
            if p.symmetric or gs == 0:
                return True
        return False

    def _filter(self, now: float, src: int, dst: int, msg):
        if self._active and self._blocked(src, dst):
            _count(self.counts, "msg_partitioned")
            return (False, 0.0, 0)
        p = self.plan
        if not p.message_faults:
            return None
        u = self._rng.random()
        if u < p.msg_loss:
            _count(self.counts, "msg_dropped")
            return (False, 0.0, 0)
        extra, dups = 0.0, 0
        if p.msg_delay and self._rng.random() < p.msg_delay:
            extra = p.delay_factor * self.sim.latency()
            _count(self.counts, "msg_delayed")
        if p.msg_dup and self._rng.random() < p.msg_dup:
            dups = 1
            _count(self.counts, "msg_duped")
        if extra == 0.0 and dups == 0:
            return None
        return (True, extra, dups)
