"""NDMP — Neighbor Discovery and Maintenance Protocols (paper §III-B).

A faithful discrete-event implementation of the FedLay control plane:

* **join** — the joining node u asks any existing node to greedy-route a
  ``Neighbor_discovery`` message toward u's coordinate in every virtual
  space (Theorem 1: greedy routing on circular distance always stops at
  the globally closest node); the stop node splices u into the ring and
  introduces both ring-adjacent peers.
* **leave** — the leaving node tells its ring-adjacent pair in every
  space to splice around it.
* **maintenance** — periodic heartbeats every ``T``; a neighbor silent
  for ``3T`` is declared failed and a ``Neighbor_repair`` message is
  greedy-routed *directionally* around the failed coordinate
  (Theorem 2: it stops at the failed node's other ring-adjacent node).
  Every node additionally sends periodic bidirectional repair probes to
  its own coordinate, which is the paper's mechanism for converging
  under *concurrent* joins and failures.

A copy of ``repro/core/ndmp.py``.  NDMP is host-side: the simulator is
exact — per-message latencies, per-node clocks, no global knowledge —
and :class:`repro_torch.overlay.controller.OverlayController` polls
:meth:`Simulator.tables_version` / :meth:`Simulator.neighbor_tables`
between training rounds and turns their deltas into mixers.  The
transport fault seam (:meth:`Simulator.set_message_filter`) and
:meth:`Simulator.rejoin` serve :class:`repro_torch.faults.ChaosEngine`;
:meth:`Simulator.export_state` is the bridge into
:class:`repro_torch.scale.VectorSimulator`'s layout.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from .coords import NodeAddress, circular_distance, coordinates
from .topology import correctness as topology_correctness


# --------------------------------------------------------------------------
# The engine seam
# --------------------------------------------------------------------------

@runtime_checkable
class SimulatorProtocol(Protocol):
    """What the overlay control plane needs from *any* NDMP engine.

    :class:`Simulator` (exact per-message discrete events, the small-n
    oracle) and :class:`repro_torch.scale.ndmp_vec.VectorSimulator` (flat-array
    batched engine for 10^5–10^6 nodes) both satisfy this, so
    :class:`repro_torch.overlay.controller.OverlayController` is engine-
    agnostic: it only ever polls the delta API and replays churn through
    the three membership calls.

    ``tables_version()`` may return any equatable value — the control
    plane compares stamps for equality, never inspects them.
    """

    now: float
    num_spaces: int

    def advance(self, dt: float) -> None: ...
    def run_until(self, t: float) -> None: ...
    def alive_ids(self) -> List[int]: ...
    def alive_addresses(self) -> List[NodeAddress]: ...
    def neighbor_tables(self) -> Dict[int, frozenset]: ...
    def tables_version(self) -> object: ...
    def correctness(self) -> float: ...
    def join(self, node_id: int, bootstrap: int,
             seeds: Tuple[int, ...] = ()) -> None: ...
    def leave(self, node_id: int) -> None: ...
    def fail(self, node_id: int) -> None: ...


# --------------------------------------------------------------------------
# Messages
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Discovery:
    """Greedy-routed join probe toward ``target`` in ``space``."""

    space: int
    target: float
    joiner: int
    joiner_coords: tuple
    hops: int = 0


@dataclasses.dataclass
class DiscoveryReply:
    """Stop node tells the joiner its two ring-adjacent peers in ``space``."""

    space: int
    pred: int
    pred_coords: tuple
    succ: int
    succ_coords: tuple


@dataclasses.dataclass
class SpliceIn:
    """Stop node tells the displaced adjacent peer to point at the joiner."""

    space: int
    joiner: int
    joiner_coords: tuple
    side: str  # "pred" or "succ": which pointer of the receiver to update


@dataclasses.dataclass
class LeaveNotice:
    """Leaving node tells one adjacent peer to adopt the other."""

    space: int
    side: str  # pointer of the receiver to rewrite
    other: int
    other_coords: tuple


@dataclasses.dataclass
class Repair:
    """Directionally greedy-routed around a (suspected-failed) coordinate."""

    space: int
    target: float
    direction: str  # "cw" | "ccw"
    origin: int
    origin_coords: tuple
    hops: int = 0


@dataclasses.dataclass
class RepairStop:
    """The node where Repair stopped introduces itself to the origin."""

    space: int
    direction: str
    stopper: int
    stopper_coords: tuple


@dataclasses.dataclass
class Heartbeat:
    sender: int


Message = object


# --------------------------------------------------------------------------
# Node state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class NodeState:
    node_id: int
    coords: tuple
    alive: bool = True
    joined: bool = False
    bootstrap: Optional[int] = None
    # rendezvous seed list: extra contacts to retry through if the
    # primary bootstrap dies mid-join (real deployments ship a seed
    # list; the paper's minimum assumption is one *live* contact)
    seeds: Tuple[int, ...] = ()
    # per-space ring pointers (clockwise successor / predecessor)
    succ: List[Optional[int]] = dataclasses.field(default_factory=list)
    pred: List[Optional[int]] = dataclasses.field(default_factory=list)
    # coordinates of every node we currently reference
    addr_book: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)
    sent_messages: int = 0
    join_messages: int = 0
    # monotone count of actual pointer rewrites — the per-node half of
    # the cheap change stamp ``Simulator.tables_version`` exposes to the
    # overlay control plane
    version: int = 0

    def init_spaces(self, num_spaces: int) -> None:
        self.succ = [None] * num_spaces
        self.pred = [None] * num_spaces

    @property
    def neighbor_set(self) -> frozenset:
        out = set()
        for x in itertools.chain(self.succ, self.pred):
            if x is not None and x != self.node_id:
                out.add(x)
        return frozenset(out)

    def set_pointer(self, space: int, side: str, peer: Optional[int],
                    peer_coords: Optional[tuple]) -> None:
        if side == "succ":
            if self.succ[space] != peer:
                self.version += 1
            self.succ[space] = peer
        else:
            if self.pred[space] != peer:
                self.version += 1
            self.pred[space] = peer
        if peer is not None and peer_coords is not None:
            self.addr_book[peer] = peer_coords
        self._prune_addr_book()

    def improve_pointer(self, space: int, side: str, peer: int,
                        peer_coords: tuple) -> bool:
        """Monotone pointer update: adopt ``peer`` only if it is strictly
        closer (in the pointer's ring direction) than the current entry.

        This is what makes concurrent-churn recovery *converge*: a repair
        or probe that stopped early on a damaged view can never clobber a
        better pointer, while genuinely closer ring-adjacent candidates
        are always accepted."""
        if peer == self.node_id:
            return False
        cur = self.succ[space] if side == "succ" else self.pred[space]
        if cur == peer:
            self.addr_book[peer] = peer_coords
            return False
        mine = self.coords[space]
        new_x = peer_coords[space]
        arc_new = ((new_x - mine) % 1.0) if side == "succ" else ((mine - new_x) % 1.0)
        if arc_new == 0.0:
            arc_new = 1.0
        if cur is not None and cur in self.addr_book:
            cur_x = self.addr_book[cur][space]
            arc_cur = ((cur_x - mine) % 1.0) if side == "succ" else ((mine - cur_x) % 1.0)
            if arc_cur == 0.0:
                arc_cur = 1.0
            if arc_new >= arc_cur:
                return False
        self.set_pointer(space, side, peer, peer_coords)
        return True

    def _prune_addr_book(self) -> None:
        keep = self.neighbor_set
        for k in list(self.addr_book):
            if k not in keep:
                del self.addr_book[k]
                self.last_seen.pop(k, None)


def _dir_arc(src: float, dst: float, direction: str) -> float:
    """Arc length from ``src`` to ``dst`` travelling in ``direction``.

    Zero-length (same point) is treated as a full wrap so that a repair
    probe targeting the sender's own coordinate routes all the way
    around to the true ring-adjacent node.
    """
    if direction == "ccw":
        arc = (src - dst) % 1.0
    else:
        arc = (dst - src) % 1.0
    return arc if arc > 0.0 else 1.0


# --------------------------------------------------------------------------
# The simulator
# --------------------------------------------------------------------------

class Simulator:
    """Discrete-event FedLay control-plane simulator.

    ``latency`` may be a float (constant one-way delay, seconds) or a
    callable ``(rng) -> float``.  All protocol logic lives in the node
    handlers below and uses **only** local state + received messages —
    no node ever reads another node's tables directly.
    """

    def __init__(self, num_spaces: int, latency: float | Callable = 0.35,
                 heartbeat_period: float = 1.0, probe_period: float = 2.0,
                 seed: int = 0, salt: str = "", max_hops: int = 512):
        self.num_spaces = num_spaces
        self.heartbeat_period = heartbeat_period
        self.probe_period = probe_period
        self.salt = salt
        self.max_hops = max_hops
        self.rng = np.random.default_rng(seed)
        self._latency = latency
        self.now = 0.0
        self._heap: List[Tuple[float, int, Tuple]] = []
        self._seq = itertools.count()
        self.nodes: Dict[int, NodeState] = {}
        self.dropped_messages = 0
        self.delivered_messages = 0
        # optional per-message fault seam (repro_torch.faults): consulted on
        # every send; None = the fault-free transport
        self._msg_filter: Optional[Callable] = None
        # monotone count of membership operations (join/leave/fail) —
        # folded into tables_version so a fail→rejoin of the same node
        # inside one control window can never alias an unchanged stamp
        self.churn_ops = 0

    # ---- event plumbing ---------------------------------------------------
    def latency(self) -> float:
        if callable(self._latency):
            return float(self._latency(self.rng))
        return float(self._latency)

    def _schedule(self, when: float, item: Tuple) -> None:
        heapq.heappush(self._heap, (when, next(self._seq), item))

    def set_message_filter(self, fn: Optional[Callable]) -> None:
        """Install a transport fault seam (or ``None`` to remove it).

        ``fn(now, src, dst, msg)`` is consulted on every :meth:`send` and
        returns ``None`` for normal delivery or a ``(deliver, extra_delay,
        duplicates)`` verdict: ``deliver=False`` drops the message (the
        sender still counts it as sent — it went onto the wire),
        ``extra_delay`` adds seconds of transit time, and ``duplicates``
        schedules that many extra copies (at-least-once transports).
        This is the control-plane fault-injection seam of
        :class:`repro_torch.faults.plan.ChaosEngine`; NDMP's handlers are
        already idempotent under loss/duplication (monotone
        ``improve_pointer``, retried discoveries, periodic probes)."""
        self._msg_filter = fn

    def send(self, src: int, dst: int, msg: Message, *, join_phase: bool = False) -> None:
        node = self.nodes.get(src)
        if node is not None:
            node.sent_messages += 1
            if join_phase:
                node.join_messages += 1
        delay = self.latency()
        if self._msg_filter is not None:
            verdict = self._msg_filter(self.now, src, dst, msg)
            if verdict is not None:
                deliver, extra_delay, duplicates = verdict
                if not deliver:
                    self.dropped_messages += 1
                    return
                delay += extra_delay
                for _ in range(duplicates):
                    self._schedule(self.now + delay, ("msg", src, dst, msg))
        self._schedule(self.now + delay, ("msg", src, dst, msg))

    def run_until(self, t: float) -> None:
        while self._heap and self._heap[0][0] <= t:
            when, _, item = heapq.heappop(self._heap)
            self.now = when
            self._dispatch(item)
        self.now = max(self.now, t)

    def run_for(self, dt: float) -> None:
        self.run_until(self.now + dt)

    def advance(self, dt: float) -> None:
        """Protocol-name alias for :meth:`run_for` (SimulatorProtocol)."""
        self.run_for(dt)

    def _dispatch(self, item: Tuple) -> None:
        kind = item[0]
        if kind == "msg":
            _, src, dst, msg = item
            node = self.nodes.get(dst)
            if node is None or not node.alive:
                self.dropped_messages += 1
                return
            self.delivered_messages += 1
            if src in node.addr_book or src in node.neighbor_set:
                node.last_seen[src] = self.now
            self._handle(node, src, msg)
        elif kind == "timer":
            _, node_id, what = item
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
            if what == "heartbeat":
                self._on_heartbeat_timer(node)
            elif what == "probe":
                self._on_probe_timer(node)
            elif what == "join_retry":
                if any(node.succ[s] is None or node.pred[s] is None
                       for s in range(self.num_spaces)):
                    self._send_discoveries(node)
                    self._schedule(self.now + self.probe_period,
                                   ("timer", node_id, "join_retry"))

    # ---- topology bootstrap -------------------------------------------------
    def seed_network(self, node_ids: List[int]) -> None:
        """Instantiate an already-correct FedLay over ``node_ids`` (the
        recursive base case: built by joining nodes one at a time is
        equivalent; this shortcut makes large-churn experiments cheap)."""
        addrs = [NodeAddress.create(i, self.num_spaces, self.salt) for i in node_ids]
        for a in addrs:
            st = NodeState(node_id=a.node_id, coords=a.coords, joined=True)
            st.init_spaces(self.num_spaces)
            self.nodes[a.node_id] = st
        for s in range(self.num_spaces):
            order = sorted(addrs, key=lambda a: (a.coords[s], a.node_id))
            n = len(order)
            for i, a in enumerate(order):
                nxt, prv = order[(i + 1) % n], order[(i - 1) % n]
                st = self.nodes[a.node_id]
                st.succ[s] = nxt.node_id if nxt.node_id != a.node_id else None
                st.pred[s] = prv.node_id if prv.node_id != a.node_id else None
                st.addr_book[nxt.node_id] = nxt.coords
                st.addr_book[prv.node_id] = prv.coords
        for nid in node_ids:
            self._arm_timers(nid)

    def _arm_timers(self, node_id: int) -> None:
        jitter = float(self.rng.random())
        self._schedule(self.now + jitter * self.heartbeat_period, ("timer", node_id, "heartbeat"))
        self._schedule(self.now + jitter * self.probe_period, ("timer", node_id, "probe"))

    # ---- public churn API ---------------------------------------------------
    def join(self, node_id: int, bootstrap: int,
             seeds: Tuple[int, ...] = ()) -> None:
        """NDMP join: node_id enters through existing node ``bootstrap``
        (``seeds``: optional fallback contacts for bootstrap failure)."""
        self.churn_ops += 1
        coords = coordinates(node_id, self.num_spaces, self.salt)
        st = NodeState(node_id=node_id, coords=coords, bootstrap=bootstrap,
                       seeds=tuple(seeds))
        st.init_spaces(self.num_spaces)
        self.nodes[node_id] = st
        self._send_discoveries(st, all_spaces=True)
        self._arm_timers(node_id)
        self._schedule(self.now + self.probe_period, ("timer", node_id, "join_retry"))

    def _send_discoveries(self, st: NodeState, all_spaces: bool = False) -> None:
        """(Re)issue Neighbor_discovery for every space still missing a
        pointer — joins are retried until they succeed, so discovery
        messages dropped at failed relays are not fatal."""
        entry = None
        if st.bootstrap is not None and st.bootstrap in self.nodes \
                and self.nodes[st.bootstrap].alive:
            entry = st.bootstrap
        if entry is None and st.addr_book:
            entry = sorted(st.addr_book)[0]
        if entry is None:
            for s in st.seeds:          # rendezvous fallback
                if s in self.nodes and self.nodes[s].alive:
                    entry = s
                    break
        if entry is None:
            return
        for s in range(self.num_spaces):
            if all_spaces or st.succ[s] is None or st.pred[s] is None:
                msg = Discovery(space=s, target=st.coords[s], joiner=st.node_id,
                                joiner_coords=st.coords)
                self.send(st.node_id, entry, msg, join_phase=True)

    def rejoin(self, node_id: int, bootstrap: int) -> None:
        """Re-anchor an *already-alive* node through ``bootstrap``:
        re-send Neighbor_discovery in every space as if joining afresh,
        keeping the current tables (the monotone ``improve_pointer`` rule
        only ever adopts strictly closer peers).

        This is the partition heal-merge mechanism: after an asymmetric
        or full partition, each side's failure detection prunes the other
        side out of every addr book, leaving two internally-correct but
        disjoint overlays that no amount of probing can reconnect (probes
        route through addr books).  Re-joining the nodes of one side
        through any live contact on the other re-establishes cross-side
        reachability; Theorem 1 splices each rejoiner at its globally
        closest coordinate and the periodic bidirectional probes converge
        the merged rings from there."""
        st = self.nodes[node_id]
        if not st.alive:
            raise KeyError(f"node {node_id} is not alive; use join()")
        self.churn_ops += 1
        st.bootstrap = bootstrap
        self._send_discoveries(st, all_spaces=True)
        self._schedule(self.now + self.probe_period,
                       ("timer", node_id, "join_retry"))

    def leave(self, node_id: int) -> None:
        """NDMP leave: notify ring-adjacent pairs, then depart."""
        self.churn_ops += 1
        st = self.nodes[node_id]
        for s in range(self.num_spaces):
            p, q = st.pred[s], st.succ[s]
            if p is not None and q is not None and p != node_id and q != node_id:
                pc = st.addr_book.get(p)
                qc = st.addr_book.get(q)
                if qc is not None:
                    self.send(node_id, p, LeaveNotice(space=s, side="succ", other=q, other_coords=qc))
                if pc is not None:
                    self.send(node_id, q, LeaveNotice(space=s, side="pred", other=p, other_coords=pc))
        st.alive = False

    def fail(self, node_id: int) -> None:
        """Abrupt failure: the node disappears without notice."""
        self.churn_ops += 1
        self.nodes[node_id].alive = False

    # ---- message handlers -----------------------------------------------------
    def _handle(self, node: NodeState, src: int, msg: Message) -> None:
        if isinstance(msg, Discovery):
            self._on_discovery(node, msg)
        elif isinstance(msg, DiscoveryReply):
            self._on_discovery_reply(node, msg)
        elif isinstance(msg, SpliceIn):
            node.improve_pointer(msg.space, msg.side, msg.joiner, msg.joiner_coords)
        elif isinstance(msg, LeaveNotice):
            # The leaving sender vacates the slot unconditionally; the
            # proposed replacement then competes under the improvement rule.
            cur = node.succ[msg.space] if msg.side == "succ" else node.pred[msg.space]
            if cur == src:
                node.set_pointer(msg.space, msg.side, msg.other, msg.other_coords)
            else:
                node.improve_pointer(msg.space, msg.side, msg.other, msg.other_coords)
        elif isinstance(msg, Repair):
            self._on_repair(node, msg)
        elif isinstance(msg, RepairStop):
            self._on_repair_stop(node, msg)
        elif isinstance(msg, Heartbeat):
            pass  # last_seen already updated in _dispatch

    # --- join: greedy routing on circular distance (Lemma 1 / Theorem 1) ---
    def _on_discovery(self, node: NodeState, msg: Discovery) -> None:
        s, x = msg.space, msg.target
        if msg.hops >= self.max_hops:
            return
        best, best_cd = None, circular_distance(node.coords[s], x)
        for w, wc in node.addr_book.items():
            cd = circular_distance(wc[s], x)
            if cd < best_cd or (cd == best_cd and best is not None and w < best):
                best, best_cd = w, cd
        if best is not None:
            self.send(node.node_id, best,
                      dataclasses.replace(msg, hops=msg.hops + 1), join_phase=True)
            return
        # Stop: this node is closest to the joiner's coordinate (Thm 1).
        self._splice_joiner(node, msg)

    def _splice_joiner(self, node: NodeState, msg: Discovery) -> None:
        s, x, u = msg.space, msg.target, msg.joiner
        succ, pred = node.succ[s], node.pred[s]
        if succ is None or pred is None:
            # Degenerate tiny ring (1-2 nodes): adopt joiner on both sides.
            node.set_pointer(s, "succ", u, msg.joiner_coords)
            if pred is None:
                node.set_pointer(s, "pred", u, msg.joiner_coords)
            self.send(node.node_id, u, DiscoveryReply(
                space=s, pred=node.node_id, pred_coords=node.coords,
                succ=node.node_id, succ_coords=node.coords), join_phase=True)
            return
        succ_c = node.addr_book.get(succ, node.coords)
        # Is x on the clockwise arc (node -> succ)?  cw arc lengths:
        arc_to_x = (x - node.coords[s]) % 1.0
        arc_to_succ = (succ_c[s] - node.coords[s]) % 1.0
        if arc_to_x <= arc_to_succ or succ == node.node_id:
            # u sits between node and its successor.
            old = succ
            old_c = node.addr_book.get(old)
            node.improve_pointer(s, "succ", u, msg.joiner_coords)
            if old is not None and old != node.node_id and old_c is not None:
                self.send(node.node_id, old,
                          SpliceIn(space=s, joiner=u, joiner_coords=msg.joiner_coords,
                                   side="pred"), join_phase=True)
                self.send(node.node_id, u, DiscoveryReply(
                    space=s, pred=node.node_id, pred_coords=node.coords,
                    succ=old, succ_coords=old_c), join_phase=True)
        else:
            # u sits between node's predecessor and node.
            old = pred
            old_c = node.addr_book.get(old)
            node.improve_pointer(s, "pred", u, msg.joiner_coords)
            if old is not None and old != node.node_id and old_c is not None:
                self.send(node.node_id, old,
                          SpliceIn(space=s, joiner=u, joiner_coords=msg.joiner_coords,
                                   side="succ"), join_phase=True)
                self.send(node.node_id, u, DiscoveryReply(
                    space=s, pred=old, pred_coords=old_c,
                    succ=node.node_id, succ_coords=node.coords), join_phase=True)

    def _on_discovery_reply(self, node: NodeState, msg: DiscoveryReply) -> None:
        node.improve_pointer(msg.space, "pred", msg.pred, msg.pred_coords)
        node.improve_pointer(msg.space, "succ", msg.succ, msg.succ_coords)
        node.joined = True

    # --- maintenance: heartbeats, failure detection, directional repair ---
    def _on_heartbeat_timer(self, node: NodeState) -> None:
        for nbr in node.neighbor_set:
            self.send(node.node_id, nbr, Heartbeat(sender=node.node_id))
        # failure detection: 3T silence
        deadline = self.now - 3.0 * self.heartbeat_period
        for nbr in list(node.neighbor_set):
            seen = node.last_seen.get(nbr)
            if seen is None:
                node.last_seen[nbr] = self.now  # grace period for new links
                continue
            if seen < deadline:
                self._declare_failed(node, nbr)
        self._schedule(self.now + self.heartbeat_period, ("timer", node.node_id, "heartbeat"))

    def _declare_failed(self, node: NodeState, failed: int) -> None:
        failed_coords = node.addr_book.get(failed)
        for s in range(self.num_spaces):
            if node.succ[s] == failed:
                # we are the failed node's predecessor -> route ccw, which
                # converges (by the directional arc metric) on its successor.
                node.set_pointer(s, "succ", None, None)
                if failed_coords is not None:
                    self._start_repair(node, s, failed_coords[s], direction="ccw")
            if node.pred[s] == failed:
                # we are the failed node's successor -> route cw to its pred.
                node.set_pointer(s, "pred", None, None)
                if failed_coords is not None:
                    self._start_repair(node, s, failed_coords[s], direction="cw")

    def _start_repair(self, node: NodeState, space: int, target: float, direction: str) -> None:
        """Route around ``target``.  Direction semantics (paper Fig. 7):
        the *predecessor* of the failed node routes **ccw** — the message
        approaches the target's coordinate from the clockwise side and
        stops at the failed node's successor; the successor routes **cw**
        and stops at the failed node's predecessor."""
        msg = Repair(space=space, target=target, direction=direction,
                     origin=node.node_id, origin_coords=node.coords)
        self._forward_repair(node, msg, first=True)

    def _forward_repair(self, node: NodeState, msg: Repair, first: bool = False) -> None:
        s, x, d = msg.space, msg.target, msg.direction
        my_arc = _dir_arc(node.coords[s], x, d)
        best, best_arc = None, my_arc
        for w, wc in node.addr_book.items():
            if w == msg.origin and not first:
                continue
            arc = _dir_arc(wc[s], x, d)
            if arc < best_arc or (arc == best_arc and best is not None and w < best):
                best, best_arc = w, arc
        if best is not None and msg.hops < self.max_hops:
            self.send(node.node_id, best, dataclasses.replace(msg, hops=msg.hops + 1))
            return
        if first:
            return  # nowhere to route (isolated) — probes will retry later
        # Stop: this node is the target's ring-adjacent node on this side.
        if node.node_id != msg.origin:
            self.send(node.node_id, msg.origin, RepairStop(
                space=s, direction=d, stopper=node.node_id, stopper_coords=node.coords))
            # ccw repair stops at the failed node's *successor*: adopt origin as pred.
            side = "pred" if d == "ccw" else "succ"
            node.improve_pointer(s, side, msg.origin, msg.origin_coords)

    def _on_repair(self, node: NodeState, msg: Repair) -> None:
        self._forward_repair(node, msg)

    def _on_repair_stop(self, node: NodeState, msg: RepairStop) -> None:
        # origin routed ccw (it was the pred) -> stopper is its new succ.
        side = "succ" if msg.direction == "ccw" else "pred"
        node.improve_pointer(msg.space, side, msg.stopper, msg.stopper_coords)

    def _on_probe_timer(self, node: NodeState) -> None:
        """Bidirectional self-probes for concurrent-churn convergence."""
        for s in range(self.num_spaces):
            for d in ("ccw", "cw"):
                msg = Repair(space=s, target=node.coords[s], direction=d,
                             origin=node.node_id, origin_coords=node.coords)
                self._forward_repair(node, msg, first=True)
        self._schedule(self.now + self.probe_period, ("timer", node.node_id, "probe"))

    # ---- measurement ---------------------------------------------------------
    def alive_addresses(self) -> List[NodeAddress]:
        return [NodeAddress(node_id=n.node_id, coords=n.coords)
                for n in self.nodes.values() if n.alive]

    def correctness(self) -> float:
        """Definition-1 correctness of the live network (paper §IV-A3)."""
        tables = {n.node_id: n.neighbor_set for n in self.nodes.values() if n.alive}
        return topology_correctness(tables, self.alive_addresses())

    def neighbor_tables(self) -> Dict[int, frozenset]:
        return {n.node_id: n.neighbor_set for n in self.nodes.values() if n.alive}

    # ---- delta API (consumed by repro_torch.overlay) -------------------------------
    def alive_ids(self) -> List[int]:
        """Sorted ids of live nodes — the control plane's slot order."""
        return sorted(n.node_id for n in self.nodes.values() if n.alive)

    def tables_version(self) -> Tuple[frozenset, int, int]:
        """Cheap O(n) change stamp over the live neighbor tables.

        ``churn_ops`` advances on every join/leave/fail (so a fail→rejoin
        of the same node can never alias, even though it resets that
        node's per-pointer version), the frozenset tracks membership, and
        within fixed membership every pointer rewrite strictly increases
        the version sum — so two equal stamps imply unchanged tables,
        letting :class:`repro_torch.overlay.events.DeltaTracker` skip the full
        diff on quiescent control steps."""
        alive = [n for n in self.nodes.values() if n.alive]
        return (frozenset(n.node_id for n in alive), self.churn_ops,
                sum(n.version for n in alive))

    def avg_messages_per_node(self, join_only: bool = False) -> float:
        counts = [(n.join_messages if join_only else n.sent_messages)
                  for n in self.nodes.values()]
        return float(np.mean(counts)) if counts else 0.0

    def export_state(self) -> Dict[str, np.ndarray]:
        """Bulk flat-array snapshot of the live network — the bridge into
        the vectorized engine's state layout (and the parity tests'
        common currency).

        Returns ``ids`` (n,) int64 sorted; ``coords`` (n, L) float64;
        ``succ``/``pred`` (L, n) int64 neighbor *ids* with −1 for an
        unset pointer; ``version`` (n,) int64 per-node pointer-rewrite
        counts."""
        ids = self.alive_ids()
        n, L = len(ids), self.num_spaces
        coords = np.empty((n, L), dtype=np.float64)
        succ = np.full((L, n), -1, dtype=np.int64)
        pred = np.full((L, n), -1, dtype=np.int64)
        version = np.empty((n,), dtype=np.int64)
        for r, u in enumerate(ids):
            st = self.nodes[u]
            coords[r] = st.coords
            version[r] = st.version
            for s in range(L):
                if st.succ[s] is not None:
                    succ[s, r] = st.succ[s]
                if st.pred[s] is not None:
                    pred[s, r] = st.pred[s]
        return {"ids": np.asarray(ids, dtype=np.int64), "coords": coords,
                "succ": succ, "pred": pred, "version": version}
