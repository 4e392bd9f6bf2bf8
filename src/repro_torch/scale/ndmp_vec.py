"""Vectorized NDMP engine — flat-array overlay maintenance at 10^5–10^6.

A copy of ``repro/scale/ndmp_vec.py``: numpy on the host, the control
plane, as the rest of :mod:`repro_torch.core` is.

See the :mod:`repro_torch.scale` package docstring for the state layout.  The
design point: the object simulator routes every protocol message
individually (exact, O(messages) Python), while this engine observes
that NDMP's *converged outcome* is a pure function of the visible
membership — per space, ring adjacency in coordinate order (Theorems 1
and 2 guarantee join splices and directional repair stop exactly
there).  So membership changes are queued with the protocol's *timing*
(splice / notify / 3T-detect deadlines) and the table update itself is
one vectorized lexsort+roll when each deadline fires.  What is lost is
per-message accounting (hop counts, transient partial tables mid-route);
what is kept is the delta API, the correctness() trajectory shape, and
bit-identical converged tables — which the parity suite in
``tests/test_torch_scale.py`` holds to the reference's engine.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.coords import NodeAddress, coordinates_batch
from ..core.ndmp import SimulatorProtocol  # noqa: F401  (the seam we satisfy)

_NONE = np.int64(-1)
_INF = float("inf")


class VectorSimulator:
    """Flat-array NDMP engine satisfying
    :class:`repro_torch.core.ndmp.SimulatorProtocol`.

    Timing model (constants mirror the object simulator's):

    * ``join``  — the joiner is a member immediately (``alive_ids`` shows
      it, as in the object sim) but splices into the rings after the
      greedy discovery route completes: ``latency · (3 + log2 m)`` for a
      network of m nodes (route ≈ log2 m hops + reply + splice).
    * ``leave`` — ring-adjacent peers splice around the leaver after one
      notify delivery: ``2 · latency``.
    * ``fail``  — neighbors detect after ``3 · heartbeat_period`` of
      silence, then repair-route: ``3T + 2 · latency``.  Until then the
      failed row stays *visible*: survivors' tables still point at it
      (stale entries), exactly the pre-detection state of the object
      simulator, and ``correctness()`` is depressed accordingly.

    Batched churn (``join_batch`` etc.) costs one queued rebuild per
    batch; single-event ``join``/``leave``/``fail`` match the protocol
    signature (``bootstrap``/``seeds`` are accepted and ignored — greedy
    discovery always converges to the same splice point regardless of
    the entry node, Theorem 1).
    """

    def __init__(self, num_spaces: int, latency: float = 0.35,
                 heartbeat_period: float = 1.0, probe_period: float = 2.0,
                 seed: int = 0, salt: str = ""):
        self.num_spaces = num_spaces
        self.heartbeat_period = heartbeat_period
        self.probe_period = probe_period
        self.salt = salt
        self.rng = np.random.default_rng(seed)
        self._latency = float(latency)
        self.now = 0.0
        self.churn_ops = 0
        # fault seams (repro_torch.faults): a message-loss delay multiplier
        # (retransmission under loss-rate p stretches every protocol
        # deadline by ~1/(1-p) in expectation) and an active partition —
        # row groups whose rings rebuild independently until healed.
        self._delay_scale = 1.0
        self._partition: Optional[List[np.ndarray]] = None

        n0 = 0
        self._ids = np.empty((n0,), dtype=np.int64)
        self._coords = np.empty((n0, num_spaces), dtype=np.float64)
        self._alive = np.empty((n0,), dtype=bool)
        self._succ = np.empty((num_spaces, n0), dtype=np.int64)
        self._pred = np.empty((num_spaces, n0), dtype=np.int64)
        self._version = np.empty((n0,), dtype=np.int64)
        self.confidence = np.empty((n0,), dtype=np.float32)
        # visibility window: the span during which a row participates in
        # ring adjacency.  visible_from > now models a join still routing
        # its discovery; visible_to <= now a detected departure.
        self._visible_from = np.empty((n0,), dtype=np.float64)
        self._visible_to = np.empty((n0,), dtype=np.float64)
        self._row_of: Dict[int, int] = {}
        self._used = 0
        # deadlines at which visibility changes => tables need a rebuild
        self._deadlines: List[float] = []
        self._tables_stale = False

    # ---- row storage -----------------------------------------------------
    def _grow(self, extra: int) -> None:
        need = self._used + extra
        cap = len(self._ids)
        if need <= cap:
            return
        new_cap = max(need, 2 * cap, 16)
        pad = new_cap - cap

        def ext(a, fill, dtype=None, axis=0):
            shape = list(a.shape)
            shape[axis] = pad
            return np.concatenate(
                [a, np.full(shape, fill, dtype=dtype or a.dtype)], axis=axis)

        self._ids = ext(self._ids, -1)
        self._coords = ext(self._coords, 0.0)
        self._alive = ext(self._alive, False)
        self._succ = ext(self._succ, _NONE, axis=1)
        self._pred = ext(self._pred, _NONE, axis=1)
        self._version = ext(self._version, 0)
        self.confidence = ext(self.confidence, 1.0)
        self._visible_from = ext(self._visible_from, _INF)
        self._visible_to = ext(self._visible_to, -_INF)

    def _rows_for(self, node_ids: np.ndarray) -> np.ndarray:
        """Rows for ``node_ids``, allocating fresh rows (with hashed
        coordinates) for ids never seen before."""
        rows = np.empty(len(node_ids), dtype=np.int64)
        fresh: List[int] = []
        for i, u in enumerate(node_ids):
            r = self._row_of.get(int(u))
            if r is None:
                fresh.append(i)
                continue
            rows[i] = r
        if fresh:
            self._grow(len(fresh))
            new_ids = node_ids[fresh]
            new_rows = np.arange(self._used, self._used + len(fresh),
                                 dtype=np.int64)
            self._used += len(fresh)
            self._ids[new_rows] = new_ids
            self._coords[new_rows] = coordinates_batch(
                new_ids.tolist(), self.num_spaces, self.salt)
            self.confidence[new_rows] = 1.0
            for r, u in zip(new_rows, new_ids):
                self._row_of[int(u)] = int(r)
            rows[fresh] = new_rows
        return rows

    # ---- deadlines and rebuilds ------------------------------------------
    def _queue_rebuild(self, when: float) -> None:
        heapq.heappush(self._deadlines, when)

    def _visible_rows(self) -> np.ndarray:
        u = self._used
        vis = (self._visible_from[:u] <= self.now) \
            & (self.now < self._visible_to[:u])
        return np.flatnonzero(vis)

    def _rebuild_tables(self) -> None:
        """Vectorized pointer repair: recompute every ring's adjacency
        over the rows visible *now*, in one lexsort+roll per space, and
        bump versions where a pointer actually moved.  Under an active
        partition each group's ring rebuilds independently — the
        converged image of cross-group failure detection + within-group
        repair."""
        u = self._used
        vis = self._visible_rows()
        if self._partition is not None:
            vis_groups = [np.intersect1d(vis, g) for g in self._partition]
        else:
            vis_groups = [vis]
        delta = np.zeros((u,), dtype=np.int64)
        for s in range(self.num_spaces):
            new = np.full((u,), _NONE, dtype=np.int64)
            new_p = np.full((u,), _NONE, dtype=np.int64)
            for grp in vis_groups:
                if len(grp) > 1:
                    order = grp[np.lexsort((self._ids[grp],
                                            self._coords[grp, s]))]
                    new[order] = np.roll(order, -1)
                    new_p[order] = np.roll(order, 1)
            delta += (new != self._succ[s, :u]).astype(np.int64)
            delta += (new_p != self._pred[s, :u]).astype(np.int64)
            self._succ[s, :u] = new
            self._pred[s, :u] = new_p
        self._version[:u] += delta
        self._tables_stale = False

    # ---- clock -----------------------------------------------------------
    def run_until(self, t: float) -> None:
        while self._deadlines and self._deadlines[0] <= t:
            when = heapq.heappop(self._deadlines)
            # coalesce deadlines at the same instant into one rebuild
            while self._deadlines and self._deadlines[0] == when:
                heapq.heappop(self._deadlines)
            self.now = when
            self._rebuild_tables()
        self.now = max(self.now, t)

    def run_for(self, dt: float) -> None:
        self.run_until(self.now + dt)

    def advance(self, dt: float) -> None:
        self.run_for(dt)

    # ---- timing constants (see class docstring) --------------------------
    def _join_delay(self) -> float:
        m = max(int(self._alive[:self._used].sum()), 2)
        return self._latency * (3.0 + math.log2(m)) * self._delay_scale

    def _leave_delay(self) -> float:
        return 2.0 * self._latency * self._delay_scale

    def _fail_delay(self) -> float:
        return (3.0 * self.heartbeat_period
                + 2.0 * self._latency * self._delay_scale)

    # ---- fault seams (repro_torch.faults) --------------------------------------
    def set_delay_scale(self, scale: float) -> None:
        """Stretch every protocol deadline by ``scale`` ≥ 1 — the
        converged-outcome image of message loss: under loss rate p each
        protocol exchange retries ~1/(1-p) times before landing, so
        joins splice, leaves notify, and failures repair later, but the
        converged tables are unchanged (still ring adjacency over the
        visible membership).  The per-message analogue is the object
        simulator's :meth:`repro_torch.core.ndmp.Simulator.set_message_filter`."""
        if scale < 1.0:
            raise ValueError(f"delay scale {scale} < 1")
        self._delay_scale = float(scale)

    def set_partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Partition the overlay into disjoint node-id ``groups``: after
        the failure-detection delay, every ring rebuilds independently
        per group (cross-group entries repaired away), exactly the
        converged state the object simulator reaches when a message
        filter drops all cross-group traffic.  Node ids absent from
        every group form no ring (unreachable from anywhere)."""
        rows = []
        seen: set = set()
        for g in groups:
            grp = np.asarray(sorted({self._row_of[int(u)] for u in g}),
                             dtype=np.int64)
            if seen & set(grp.tolist()):
                raise ValueError("partition groups overlap")
            seen |= set(grp.tolist())
            rows.append(grp)
        self._partition = rows
        self._queue_rebuild(self.now + self._fail_delay())

    def heal_partition(self) -> None:
        """Lift the active partition: after the discovery-route delay
        the rings re-merge over the full visible membership (the
        converged image of the object simulator's cross-side
        :meth:`~repro_torch.core.ndmp.Simulator.rejoin` sweep)."""
        self._partition = None
        self._queue_rebuild(self.now + self._join_delay())

    def rejoin(self, node_id: int, bootstrap: Optional[int] = None) -> None:
        """Protocol-surface twin of the object simulator's ``rejoin``:
        an alive node re-anchoring through ``bootstrap``.  Membership is
        unchanged; tables re-converge after the discovery delay."""
        del bootstrap
        r = self._row_of.get(int(node_id))
        if r is None or not self._alive[r]:
            raise KeyError(f"node {int(node_id)} is not alive")
        self.churn_ops += 1
        self._queue_rebuild(self.now + self._join_delay())

    # ---- batched churn ---------------------------------------------------
    def seed_network(self, node_ids: Sequence[int]) -> None:
        """Instantiate an already-correct FedLay over ``node_ids`` (same
        shortcut as the object simulator's ``seed_network``)."""
        arr = np.asarray(list(node_ids), dtype=np.int64)
        rows = self._rows_for(arr)
        self._alive[rows] = True
        self._visible_from[rows] = self.now
        self._visible_to[rows] = _INF
        self._rebuild_tables()

    def join_batch(self, node_ids: Sequence[int]) -> None:
        """Batched join: all of ``node_ids`` enter now, splice in after
        the discovery-route delay (one rebuild for the whole batch)."""
        arr = np.asarray(list(node_ids), dtype=np.int64)
        if arr.size == 0:
            return
        rows = self._rows_for(arr)
        if self._alive[rows].any():
            dup = self._ids[rows[self._alive[rows]]][0]
            raise ValueError(f"node {int(dup)} is already alive")
        self.churn_ops += int(arr.size)
        when = self.now + self._join_delay()
        self._alive[rows] = True
        self._version[rows] = 0      # fail→rejoin resets, like a fresh NodeState
        self._visible_from[rows] = when
        self._visible_to[rows] = _INF
        self._queue_rebuild(when)

    def _depart_batch(self, node_ids: Sequence[int], delay: float) -> None:
        arr = np.asarray(list(node_ids), dtype=np.int64)
        if arr.size == 0:
            return
        rows = np.empty(arr.size, dtype=np.int64)
        for i, nid in enumerate(arr):
            r = self._row_of.get(int(nid))
            if r is None or not self._alive[r]:
                raise KeyError(f"node {int(nid)} is not alive")
            rows[i] = r
        self.churn_ops += int(arr.size)
        when = self.now + delay
        self._alive[rows] = False
        self._visible_to[rows] = np.minimum(self._visible_to[rows], when)
        self._queue_rebuild(when)

    def leave_batch(self, node_ids: Sequence[int]) -> None:
        self._depart_batch(node_ids, self._leave_delay())

    def fail_batch(self, node_ids: Sequence[int]) -> None:
        self._depart_batch(node_ids, self._fail_delay())

    # ---- single-event protocol surface -----------------------------------
    def join(self, node_id: int, bootstrap: Optional[int] = None,
             seeds: Tuple[int, ...] = ()) -> None:
        del bootstrap, seeds  # Theorem 1: splice point is entry-invariant
        self.join_batch([node_id])

    def leave(self, node_id: int) -> None:
        self.leave_batch([node_id])

    def fail(self, node_id: int) -> None:
        self.fail_batch([node_id])

    # ---- delta API (SimulatorProtocol) -----------------------------------
    def alive_ids(self) -> List[int]:
        rows = np.flatnonzero(self._alive[:self._used])
        return sorted(int(i) for i in self._ids[rows])

    def alive_addresses(self) -> List[NodeAddress]:
        rows = np.flatnonzero(self._alive[:self._used])
        return [NodeAddress(node_id=int(self._ids[r]),
                            coords=tuple(self._coords[r]))
                for r in rows]

    def neighbor_tables(self) -> Dict[int, frozenset]:
        """id → neighbor-id frozenset for live nodes.  O(n·L) Python —
        meant for control-plane populations; population-scale consumers
        should read :meth:`neighbor_rows` instead."""
        rows = np.flatnonzero(self._alive[:self._used])
        out: Dict[int, frozenset] = {}
        for r in rows:
            nbr = set()
            for s in range(self.num_spaces):
                for p in (self._succ[s, r], self._pred[s, r]):
                    if p >= 0 and p != r:
                        nbr.add(int(self._ids[p]))
            out[int(self._ids[r])] = frozenset(nbr)
        return out

    def neighbor_rows(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The flat view: (alive_rows, succ (L, n), pred (L, n)) with
        pointers re-expressed as *positions into alive_rows* (−1 where
        the pointer is unset or points at a non-alive row) — the
        zero-copy-ish currency of population-scale benchmarks."""
        u = self._used
        rows = np.flatnonzero(self._alive[:u])
        pos = np.full((u,), -1, dtype=np.int64)
        pos[rows] = np.arange(len(rows))
        succ = np.full((self.num_spaces, len(rows)), -1, dtype=np.int64)
        pred = np.full((self.num_spaces, len(rows)), -1, dtype=np.int64)
        for s in range(self.num_spaces):
            sp = self._succ[s, rows]
            pp = self._pred[s, rows]
            succ[s] = np.where(sp >= 0, pos[np.maximum(sp, 0)], -1)
            pred[s] = np.where(pp >= 0, pos[np.maximum(pp, 0)], -1)
        return rows, succ, pred

    def tables_version(self) -> Tuple[int, int, int]:
        """Opaque equatable change stamp (same contract as the object
        simulator's): equal stamps ⇒ unchanged live tables."""
        u = self._used
        alive = self._alive[:u]
        return (self.churn_ops, int(alive.sum()),
                int(self._version[:u][alive].sum()))

    def correctness(self) -> float:
        """Definition-1 correctness of the live network, vectorized.

        counts correct entries / (required + stale) exactly like
        :func:`repro_torch.core.topology.correctness`: required entries are
        the ring adjacencies over the *alive* set; a live node's table
        entry pointing at a departed-but-undetected row (or missing a
        freshly required edge) counts against it.
        """
        u = self._used
        alive_rows = np.flatnonzero(self._alive[:u])
        n = len(alive_rows)
        if n <= 1:
            return 1.0
        # the required (Definition-1) undirected edge set over alive rows
        want = set()
        for s in range(self.num_spaces):
            order = alive_rows[np.lexsort((self._ids[alive_rows],
                                           self._coords[alive_rows, s]))]
            nxt = np.roll(order, -1)
            for a, b in zip(order, nxt):
                if a != b:
                    want.add((min(int(a), int(b)), max(int(a), int(b))))
        required: Dict[int, set] = {int(r): set() for r in alive_rows}
        for a, b in want:
            required[a].add(b)
            required[b].add(a)
        total = sum(len(v) for v in required.values())
        got_correct = 0
        extra = 0
        for r in alive_rows:
            have = set()
            for s in range(self.num_spaces):
                for p in (self._succ[s, r], self._pred[s, r]):
                    if p >= 0 and p != r:
                        have.add(int(p))
            w = required[int(r)]
            got_correct += len(have & w)
            extra += len(have - w)
        denom = total + extra
        return got_correct / denom if denom else 1.0

    # ---- bulk state ------------------------------------------------------
    def export_state(self) -> Dict[str, np.ndarray]:
        """Same layout as :meth:`repro_torch.core.ndmp.Simulator.export_state`:
        live rows in sorted-id order, pointers as node ids (−1 unset)."""
        u = self._used
        rows = np.flatnonzero(self._alive[:u])
        rows = rows[np.argsort(self._ids[rows])]
        n, L = len(rows), self.num_spaces
        succ = np.full((L, n), -1, dtype=np.int64)
        pred = np.full((L, n), -1, dtype=np.int64)
        for s in range(L):
            sp = self._succ[s, rows]
            pp = self._pred[s, rows]
            succ[s] = np.where(sp >= 0, self._ids[np.maximum(sp, 0)], -1)
            pred[s] = np.where(pp >= 0, self._ids[np.maximum(pp, 0)], -1)
        return {"ids": self._ids[rows].copy(),
                "coords": self._coords[rows].copy(),
                "succ": succ, "pred": pred,
                "version": self._version[rows].copy()}

    @classmethod
    def from_simulator(cls, sim, **kwargs) -> "VectorSimulator":
        """Seed a vectorized engine from any engine exposing
        ``export_state()`` (typically the object oracle): membership and
        converged tables carry over; in-flight protocol messages do not."""
        state = sim.export_state()
        out = cls(num_spaces=sim.num_spaces,
                  latency=kwargs.pop("latency", getattr(sim, "_latency", 0.35)
                                     if not callable(getattr(sim, "_latency", None))
                                     else 0.35),
                  heartbeat_period=kwargs.pop("heartbeat_period",
                                              sim.heartbeat_period),
                  probe_period=kwargs.pop("probe_period", sim.probe_period),
                  salt=kwargs.pop("salt", sim.salt), **kwargs)
        out.now = sim.now
        ids = state["ids"]
        rows = out._rows_for(ids)
        out._coords[rows] = state["coords"]   # authoritative (same hash anyway)
        out._alive[rows] = True
        out._visible_from[rows] = out.now
        out._visible_to[rows] = _INF
        out._version[rows] = state["version"]
        id_row = out._row_of
        for s in range(out.num_spaces):
            for k, arr in (("succ", out._succ), ("pred", out._pred)):
                src = state[k][s]
                arr[s, rows] = [id_row.get(int(v), -1) if v >= 0 else -1
                                for v in src]
        return out

    # ---- misc ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        """Total rows ever allocated (alive + departed identities)."""
        return self._used

    def set_confidence(self, node_ids: Sequence[int],
                       values: Sequence[float]) -> None:
        """Install per-node MEP confidences (cohort sampling / donor
        selection weight); ids must have rows already."""
        for u, c in zip(node_ids, values):
            self.confidence[self._row_of[int(u)]] = c
