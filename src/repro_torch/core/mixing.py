"""Mixing schedules: the FedLay overlay as 2L static ring rotations.

A copy of ``repro/core/mixing.py``.  The simulation path
(:class:`repro_torch.core.dfl.Engine`'s semantics as one matrix) is
:func:`confidence_mixing_matrix` and :func:`gossip_step`.  Each virtual
ring space is a cyclic order over the client slots, so one space = one
source permutation in each direction.
Confidence weights and duplicate-adjacency masks (a peer adjacent in
several spaces is counted once) are precomputed host-side into dense
per-slot weight tables.  :func:`masked_mixing_matrix` is the dense
oracle the tests hold :func:`repro_torch.dist.sync.global_mixer` to.

The **grouped layout** (G clients per rank of a process group) splits a
schedule into intra-rank takes and edge-colored rounds of cross-rank
point-to-point messages (:func:`grouped_routing`), which
:func:`repro_torch.dist.sync.fedlay_mix` runs; :func:`grouped_mix_reference`
is its numpy oracle.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .coords import NodeAddress, coordinate
from .mep import ClientProfile, aggregation_weights
from .topology import Topology, fedlay_topology, ring_orders


# --------------------------------------------------------------------------
# Confidence-weighted mixing matrix (simulation path)
# --------------------------------------------------------------------------

def confidence_mixing_matrix(topology: Topology,
                             profiles: Dict[int, ClientProfile],
                             alpha_d: float = 0.5, alpha_c: float = 0.5,
                             confidence_weighted: bool = True) -> np.ndarray:
    """Row i = MEP aggregation weights of client i over {i} ∪ N_i.

    Row-stochastic by construction.  With ``confidence_weighted=False``
    this is the DFedAvg simple average (the paper's ablation)."""
    index = {u: k for k, u in enumerate(topology.nodes)}
    n = topology.n
    W = np.zeros((n, n), dtype=np.float64)
    nbrs = topology.neighbor_map()
    for u in topology.nodes:
        others = nbrs[u]
        w = aggregation_weights(profiles[u], [profiles[v] for v in others],
                                alpha_d, alpha_c, confidence_weighted)
        W[index[u], index[u]] = w[0]
        for k, v in enumerate(others):
            W[index[u], index[v]] = w[k + 1]
    return W


def gossip_step(stacked_models: np.ndarray, W: np.ndarray) -> np.ndarray:
    """One synchronous mixing round: X ← W·X for (n, dim) stacked models."""
    return W @ stacked_models


@dataclasses.dataclass(frozen=True, eq=False)
class PermuteSchedule:
    """Everything :func:`repro_torch.dist.sync.global_mixer` and
    :func:`repro_torch.dist.sync.make_mixer` need, all host-side static.

    ``perms[k]`` is the source-permutation of the k-th incoming slot:
    device ``i`` receives the model held by device ``perms[k][i]``.
    Slots come in (space, direction) order: (0,cw),(0,ccw),(1,cw)...
    ``weights[i, k]`` is the MEP confidence weight of that incoming
    model at device ``i`` — already zeroed for duplicate adjacencies and
    self-loops — and ``self_weight[i]`` is c_i.  Rows are normalized so
    ``self_weight[i] + Σ_k weights[i,k] == 1``.

    Schedules are value-hashable (perms + weights digest), so they can
    key the overlay controller's mixer compile cache and dict/set-based
    test assertions directly.
    """

    num_clients: int
    num_spaces: int
    perms: Tuple[Tuple[int, ...], ...]        # (2L, n) source index per device
    weights: np.ndarray                       # (n, 2L) float32
    self_weight: np.ndarray                   # (n,) float32

    @property
    def num_slots(self) -> int:
        return 2 * self.num_spaces

    def digest(self) -> str:
        """Stable content hash over shape, perms, and (f32-exact) weights."""
        cached = self.__dict__.get("_digest")
        if cached is None:
            h = hashlib.sha256()
            h.update(np.asarray([self.num_clients, self.num_spaces],
                                np.int64).tobytes())
            h.update(np.asarray(self.perms, np.int64).tobytes())
            h.update(np.ascontiguousarray(self.weights,
                                          np.float32).tobytes())
            h.update(np.ascontiguousarray(self.self_weight,
                                          np.float32).tobytes())
            cached = h.hexdigest()
            object.__setattr__(self, "_digest", cached)
        return cached

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PermuteSchedule):
            return NotImplemented
        return self.digest() == other.digest()

    def __hash__(self) -> int:
        return hash(self.digest())


def build_permute_schedule(num_clients: int, num_spaces: int,
                           profiles: Optional[Dict[int, ClientProfile]] = None,
                           alpha_d: float = 0.5, alpha_c: float = 0.5,
                           confidence_weighted: bool = True,
                           salt: str = "",
                           pod_bias: Optional[int] = None,
                           pod_bias_spaces: Optional[int] = None) -> PermuteSchedule:
    """Compile a FedLay overlay over client positions 0..n-1 into the
    2L-rotation schedule.  Client identity = position; coordinates are
    hashed from it exactly as the paper hashes IP addresses.

    ``pod_bias`` (beyond the paper): with P pods of n/P clients each, the
    coordinates of the first ``pod_bias_spaces`` spaces (default: all)
    become ``(pod(i) + H(i|s)) / P``, so each of those rings orders the
    clients pod by pod and exactly P of its n edges cross a pod boundary;
    the other spaces stay fully random, for mixing quality."""
    n = num_clients
    if pod_bias:
        if n % pod_bias:
            raise ValueError(f"{n} clients do not divide into {pod_bias} pods")
        per = n // pod_bias
        nb = num_spaces if pod_bias_spaces is None else pod_bias_spaces

        def coord(i: int, s: int) -> float:
            u = coordinate(i, s, salt)
            if s < nb:          # pod-contiguous ring
                return (i // per + u) / pod_bias
            return u            # fully random ring (mixing quality)

        addrs = [NodeAddress(node_id=i, coords=tuple(
            coord(i, s) for s in range(num_spaces))) for i in range(n)]
    else:
        addrs = [NodeAddress.create(i, num_spaces, salt) for i in range(n)]
    return schedule_from_addresses(addrs, profiles=profiles, alpha_d=alpha_d,
                                   alpha_c=alpha_c,
                                   confidence_weighted=confidence_weighted)


def schedule_from_addresses(addrs: Sequence[NodeAddress],
                            profiles: Optional[Dict[int, ClientProfile]] = None,
                            alpha_d: float = 0.5, alpha_c: float = 0.5,
                            confidence_weighted: bool = True) -> PermuteSchedule:
    """Compile the FedLay overlay over an explicit node set into a
    :class:`PermuteSchedule` — device slot ``i`` hosts ``addrs[i]``.

    This is the live-churn entry point used by
    :class:`repro_torch.overlay.controller.OverlayController`: node ids are
    arbitrary (NDMP identities, not mesh indices), ``profiles`` is keyed
    by node id, and the returned perms/weights are in *slot* space so
    they drop straight into :func:`repro_torch.dist.sync.global_mixer`
    for the current alive set.
    """
    n = len(addrs)
    if n == 0:
        raise ValueError("cannot build a schedule over zero nodes")
    num_spaces = addrs[0].num_spaces
    slot_of = {a.node_id: i for i, a in enumerate(addrs)}
    if len(slot_of) != n:
        raise ValueError("duplicate node ids in address list")
    orders = ring_orders(addrs)  # per space: clockwise id order

    # incoming source slot per device slot per (space, direction)
    perms: List[Tuple[int, ...]] = []
    senders = np.zeros((n, 2 * num_spaces), dtype=np.int64)
    for s in range(num_spaces):
        order = [slot_of[u] for u in orders[s]]
        pos = {u: k for k, u in enumerate(order)}
        succ = [0] * n
        pred = [0] * n
        for u in range(n):
            succ[u] = order[(pos[u] + 1) % n]
            pred[u] = order[(pos[u] - 1) % n]
        # slot 2s: receive from clockwise predecessor; slot 2s+1: successor
        perms.append(tuple(pred))
        perms.append(tuple(succ))
        senders[:, 2 * s] = pred
        senders[:, 2 * s + 1] = succ

    # confidence weights with duplicate-adjacency masking
    topo = fedlay_topology(addrs)
    nbr_map = topo.neighbor_map()
    if profiles is None:
        profiles = {
            a.node_id: ClientProfile(client_id=a.node_id, period=1.0,
                                     label_histogram=np.ones(2))
            for a in addrs
        }
    weights = np.zeros((n, 2 * num_spaces), dtype=np.float64)
    self_w = np.zeros((n,), dtype=np.float64)
    for i, a in enumerate(addrs):
        others = nbr_map[a.node_id]
        w = aggregation_weights(profiles[a.node_id],
                                [profiles[v] for v in others],
                                alpha_d, alpha_c, confidence_weighted)
        self_w[i] = w[0]
        per_peer = {slot_of[v]: w[k + 1] for k, v in enumerate(others)}
        seen: set = set()
        for k in range(2 * num_spaces):
            src = int(senders[i, k])
            if src == i or src in seen:
                weights[i, k] = 0.0  # self-ring (n small) or duplicate adjacency
            else:
                weights[i, k] = per_peer[src]
                seen.add(src)
    total = self_w + weights.sum(axis=1)
    weights /= total[:, None]
    self_w /= total
    return PermuteSchedule(
        num_clients=n, num_spaces=num_spaces,
        perms=tuple(perms),
        weights=weights.astype(np.float32),
        self_weight=self_w.astype(np.float32),
    )


def pad_schedule(sched: PermuteSchedule, slots: Sequence[int],
                 capacity: int) -> PermuteSchedule:
    """Embed an n-client schedule into a fixed ``capacity``-slot layout.

    ``slots[i]`` is the capacity slot hosting schedule slot ``i`` (the
    :class:`repro_torch.runtime.slots.SlotMap` assignment).  Dead capacity
    slots **self-loop with weight 1**: identity perms, zero incoming
    weights, self weight 1 — so a mixer compiled over the padded
    schedule leaves dead rows untouched and never reads from them, and
    the padded mixing matrix stays row-stochastic.  Padded schedules
    hash by content like any other, so the overlay controller's compile
    cache keys on them directly (same alive set + same slot layout ⇒
    zero retrace).
    """
    n = sched.num_clients
    if len(slots) != n:
        raise ValueError(f"need one slot per schedule client: got "
                         f"{len(slots)} slots for {n} clients")
    if len(set(slots)) != n:
        raise ValueError("duplicate capacity slots")
    if any(s < 0 or s >= capacity for s in slots):
        raise ValueError(f"slot out of range for capacity {capacity}")
    perms: List[Tuple[int, ...]] = []
    for k in range(sched.num_slots):
        perm = list(range(capacity))          # dead slots: self-loop
        for i in range(n):
            perm[slots[i]] = slots[sched.perms[k][i]]
        perms.append(tuple(perm))
    weights = np.zeros((capacity, sched.num_slots), dtype=np.float32)
    self_w = np.ones((capacity,), dtype=np.float32)
    idx = np.asarray(slots, dtype=np.int64)
    weights[idx] = sched.weights
    self_w[idx] = sched.self_weight
    return PermuteSchedule(num_clients=capacity, num_spaces=sched.num_spaces,
                           perms=tuple(perms), weights=weights,
                           self_weight=self_w)


# --------------------------------------------------------------------------
# Grouped layout: G local clients per rank
# --------------------------------------------------------------------------
#
# With ``clients_per_device = G`` the flat client axis maps onto the ranks
# of a process group block-contiguously: client ``i`` lives on rank
# ``i // G`` at local row ``i % G``.  A schedule slot's source permutation
# then splits into *intra-rank* edges (source on the same rank — a local
# take, zero network bytes) and *cross-rank* edges.  The cross edges of
# one slot are not a rank permutation in general (a rank may receive from
# up to G distinct peers a slot), so they are edge-colored into rounds,
# each a partial rank permutation (unique sources, unique destinations)
# carrying one model row per participating rank.  Zero-weight edges
# (self-loops at tiny n, duplicate adjacencies, dead capacity slots of a
# padded schedule) are pruned and never touch the wire.

@dataclasses.dataclass(frozen=True)
class CrossRound:
    """One edge-color class of a slot's cross-rank edges: a partial rank
    permutation (unique sources, unique destinations) moving one model
    row per participating rank."""

    pairs: Tuple[Tuple[int, int], ...]   # (src_rank, dst_rank) pairs
    send_row: np.ndarray                 # (D,) int32: local row each source sends
    recv_slot: np.ndarray                # (D,) int32: local row the value lands in
    recv_on: np.ndarray                  # (D,) float32: 1 where this rank receives


@dataclasses.dataclass(frozen=True)
class GroupedRouting:
    """Host-static routing tables turning a flat n-client schedule into a
    grouped (G clients per rank) program, run by
    :func:`repro_torch.dist.sync.fedlay_mix` and checked host-side by
    :func:`grouped_mix_reference`."""

    clients_per_device: int
    num_devices: int
    intra_src: Tuple[np.ndarray, ...]            # per slot: (D, G) int32
    intra_on: Tuple[np.ndarray, ...]             # per slot: (D, G) float32
    rounds: Tuple[Tuple[CrossRound, ...], ...]   # per slot

    @property
    def cross_edges(self) -> int:
        """Cross-rank (weight > 0) edges per mixing round — each costs one
        model row on the wire."""
        return sum(len(r.pairs) for slot in self.rounds for r in slot)

    @property
    def max_rounds(self) -> int:
        return max((len(slot) for slot in self.rounds), default=0)


def check_group_size(num_clients: int, clients_per_device: int) -> int:
    """Validate the grouped-layout contract (shared by every
    ``clients_per_device`` consumer) and return the device count
    ``num_clients // clients_per_device``."""
    if clients_per_device < 1:
        raise ValueError("clients_per_device must be >= 1")
    if num_clients % clients_per_device:
        raise ValueError(
            f"{num_clients} clients do not divide into groups of "
            f"{clients_per_device}")
    return num_clients // clients_per_device


def _bipartite_edge_coloring(edges: List[Tuple[int, int]],
                             num_nodes: int) -> List[int]:
    """Color a bipartite multigraph's edges (src node → dst node, the two
    sides indexed independently) with exactly Δ colors (König's theorem,
    constructive Kempe-chain proof): every color class has unique sources
    and unique destinations.

    Returns one color per edge, all in ``range(Δ)`` where Δ is the max
    degree of any source or destination.  O(E·Δ) — each insertion flips
    at most one alternating path."""
    if not edges:
        return []
    deg_s = [0] * num_nodes
    deg_d = [0] * num_nodes
    for s, d in edges:
        deg_s[s] += 1
        deg_d[d] += 1
    delta = max(max(deg_s), max(deg_d))
    # per-node color tables: color -> edge id (or -1)
    s_used = [[-1] * delta for _ in range(num_nodes)]
    d_used = [[-1] * delta for _ in range(num_nodes)]
    color = [-1] * len(edges)
    for eid, (u, v) in enumerate(edges):
        a = next(c for c in range(delta) if s_used[u][c] == -1)
        b = next(c for c in range(delta) if d_used[v][c] == -1)
        if a != b:
            # Kempe chain: flip the maximal a/b-alternating path from v
            # (starting along v's a-edge).  It cannot reach u — left
            # nodes are entered via a-edges and a is free at u — so a
            # becomes free at both endpoints.
            x, side = v, 1                   # 1: destination side
            ca, cb = a, b
            e = d_used[x][ca]
            while e != -1:
                es, ed = edges[e]
                y = es if side == 1 else ed  # the far endpoint
                ytab = s_used if side == 1 else d_used
                nxt = ytab[y][cb]            # continuation, pre-overwrite
                if s_used[es][ca] == e:
                    s_used[es][ca] = -1
                if d_used[ed][ca] == e:
                    d_used[ed][ca] = -1
                s_used[es][cb] = e
                d_used[ed][cb] = e
                color[e] = cb
                x, side = y, 1 - side
                ca, cb = cb, ca
                e = nxt
        color[eid] = a
        s_used[u][a] = eid
        d_used[v][a] = eid
    return color


@functools.lru_cache(maxsize=256)
def grouped_routing(sched: PermuteSchedule,
                    clients_per_device: int) -> GroupedRouting:
    """Decompose a schedule for the grouped layout (client ``i`` → rank
    ``i // G``): per slot, intra-rank take tables plus optimally
    edge-colored cross-rank rounds.  One slot's cross edges form a
    bipartite multigraph of max degree Δ ≤ G (each client receives once
    and sends once a slot), so König coloring packs them into exactly
    Δ ≤ G rounds.  Cached by schedule content (schedules hash by digest);
    the cached arrays are read-only."""
    G = clients_per_device
    n = sched.num_clients
    D = check_group_size(n, G)
    intra_src: List[np.ndarray] = []
    intra_on: List[np.ndarray] = []
    all_rounds: List[Tuple[CrossRound, ...]] = []
    for k in range(sched.num_slots):
        isrc = np.zeros((D, G), np.int32)
        ion = np.zeros((D, G), np.float32)
        cross: List[Tuple[int, int]] = []       # (src_rank, dst_rank)
        cross_rows: List[Tuple[int, int]] = []  # (send_row, recv_slot)
        for i in range(n):
            if float(sched.weights[i, k]) <= 0.0:
                continue    # self-loop, duplicate adjacency, or dead slot
            src = sched.perms[k][i]
            d, l = divmod(i, G)
            sd, sl = divmod(src, G)
            if sd == d:
                isrc[d, l] = sl
                ion[d, l] = 1.0
            else:
                cross.append((sd, d))
                cross_rows.append((sl, l))
        colors = _bipartite_edge_coloring(cross, D)
        rounds: List[dict] = []
        for c in range(max(colors) + 1 if colors else 0):
            rounds.append({"pairs": [],
                           "send": np.zeros((D,), np.int32),
                           "recv": np.zeros((D,), np.int32),
                           "on": np.zeros((D,), np.float32)})
        for (sd, d), (sl, l), c in zip(cross, cross_rows, colors):
            r = rounds[c]
            r["pairs"].append((sd, d))
            r["send"][sd] = sl
            r["recv"][d] = l
            r["on"][d] = 1.0
        # the routing is cached and shared by every mixer of the schedule:
        # freeze every array so that a consumer cannot write into it
        for arr in (isrc, ion, *(a for r in rounds
                                 for a in (r["send"], r["recv"], r["on"]))):
            arr.flags.writeable = False
        intra_src.append(isrc)
        intra_on.append(ion)
        all_rounds.append(tuple(
            CrossRound(pairs=tuple(r["pairs"]), send_row=r["send"],
                       recv_slot=r["recv"], recv_on=r["on"])
            for r in rounds))
    return GroupedRouting(
        clients_per_device=G, num_devices=D,
        intra_src=tuple(intra_src), intra_on=tuple(intra_on),
        rounds=tuple(all_rounds))


def grouped_mix_reference(sched: PermuteSchedule, X: np.ndarray,
                          clients_per_device: int,
                          mask: Optional[Sequence[float]] = None) -> np.ndarray:
    """The grouped dense oracle: mix (n, dim) stacked models via the
    grouped decomposition (intra takes + edge-colored cross rounds) in
    pure numpy, float64.  Equals ``masked_mixing_matrix(sched, mask) @ X``
    (``schedule_mixing_matrix(sched) @ X`` unmasked) for every schedule
    and G — the host-side proof that the routing tables rebuild the flat
    schedule."""
    rt = grouped_routing(sched, clients_per_device)
    G, D = rt.clients_per_device, rt.num_devices
    Xf = np.asarray(X, np.float64)
    local = Xf.reshape((D, G) + Xf.shape[1:])
    m = (np.ones((sched.num_clients,)) if mask is None
         else np.asarray(mask, np.float64)).reshape(D, G)

    def receive(vals):
        """Per slot: (D, G, ...) array of each local row's source value."""
        out = []
        for k in range(sched.num_slots):
            V = np.zeros_like(vals)
            for d in range(D):
                for l in range(G):
                    if rt.intra_on[k][d, l] > 0:
                        V[d, l] = vals[d, rt.intra_src[k][d, l]]
            for rnd in rt.rounds[k]:
                for sd, dd in rnd.pairs:
                    V[dd, rnd.recv_slot[dd]] = vals[sd, rnd.send_row[sd]]
            out.append(V)
        return out

    recv_vals = receive(local)
    recv_mask = receive(m)
    W = sched.weights.astype(np.float64).reshape(
        (D, G, sched.num_slots))
    self_w = sched.self_weight.astype(np.float64).reshape(D, G)
    eff = [W[:, :, k] * recv_mask[k] for k in range(sched.num_slots)]
    total = self_w + sum(eff)
    ok = (m > 0) & (total > 0)
    safe = np.where(total > 0, total, 1.0)
    bshape = (D, G) + (1,) * (Xf.ndim - 1)
    acc = local * (self_w / safe).reshape(bshape)
    for k in range(sched.num_slots):
        acc = acc + recv_vals[k] * (eff[k] / safe).reshape(bshape)
    acc = np.where(ok.reshape(bshape), acc, local)
    return acc.reshape(Xf.shape)


def masked_mixing_matrix(sched: PermuteSchedule,
                         mask: Sequence[float],
                         edge_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Dense equivalent of mask-aware mixing (the test oracle for
    :func:`repro_torch.dist.sync.global_mixer` with ``masked=True``).

    Row ``i`` with ``mask[i] == 0`` is the identity (a dead or skipping
    client keeps its own model and contributes to nobody).  Live rows
    drop masked-out sources and renormalize over the surviving weights,
    so the matrix stays row-stochastic for any 0/1 mask.

    ``edge_mask`` (optional, (n, 2L) 0/1) additionally drops the edge
    from row ``i``'s k-th source before renormalizing — the degraded
    -round oracle for :mod:`repro_torch.faults` link outages/stragglers.  A
    live row with every edge down degenerates to the identity (it
    keeps its own model: total = self_weight > 0)."""
    m = np.asarray(mask, dtype=np.float64)
    n = sched.num_clients
    if m.shape != (n,):
        raise ValueError(f"mask shape {m.shape} != ({n},)")
    if edge_mask is not None:
        edge_mask = np.asarray(edge_mask, dtype=np.float64)
        if edge_mask.shape != (n, sched.num_slots):
            raise ValueError(
                f"edge_mask shape {edge_mask.shape} != ({n}, {sched.num_slots})")
    W = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        if m[i] == 0.0:
            W[i, i] = 1.0
            continue
        eff = np.asarray(
            [float(sched.weights[i, k]) * m[sched.perms[k][i]]
             for k in range(sched.num_slots)])
        if edge_mask is not None:
            eff = eff * edge_mask[i]
        total = float(sched.self_weight[i]) + eff.sum()
        if total <= 0.0:
            W[i, i] = 1.0
            continue
        W[i, i] = float(sched.self_weight[i]) / total
        for k in range(sched.num_slots):
            W[i, sched.perms[k][i]] += eff[k] / total
    return W


def schedule_mixing_matrix(sched: PermuteSchedule) -> np.ndarray:
    """Dense equivalent W of an unmasked permute schedule (a test
    oracle)."""
    n = sched.num_clients
    W = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        W[i, i] = sched.self_weight[i]
        for k in range(sched.num_slots):
            src = sched.perms[k][i]
            W[i, src] += float(sched.weights[i, k])
    return W


def cross_pod_messages(sched: PermuteSchedule, pods: int) -> int:
    """Messages per mixing round that cross a pod boundary (clients are
    laid out pod-contiguously: pod(i) = i // (n/pods))."""
    n = sched.num_clients
    per = n // pods
    crossing = 0
    for k in range(sched.num_slots):
        for dst, src in enumerate(sched.perms[k]):
            if src // per != dst // per:
                crossing += 1
    return crossing


def participation_mults(periods: Sequence[float]) -> np.ndarray:
    """Per-client periods → integer step multiples k_u (client u joins
    the mixing collective every k_u local steps).  Host-side static; the
    on-device mask for a traced step counter is
    :func:`repro_torch.runtime.masked.participation_mask`."""
    base = min(periods)
    return np.maximum(1, np.round(np.asarray(periods) / base).astype(np.int64))


def multirate_participation(periods: Sequence[float], step: int) -> np.ndarray:
    """Bulk-synchronous image of MEP asynchrony: client u participates in
    the mixing collective at step t iff t % k_u == 0, where k_u is its
    period expressed in (integer) local steps.  Returns a 0/1 mask."""
    return (step % participation_mults(periods) == 0).astype(np.float32)
