"""Mixing schedules: the FedLay overlay as 2L static ring rotations.

A copy of ``repro/core/mixing.py``, trimmed to what the DFL round calls
(the grouped multi-device routing waits for ROADMAP.md Queue 1 item 10).
Each virtual ring space is a cyclic order over the client slots, so one
space = one source permutation in each direction.  Confidence weights
and duplicate-adjacency masks (a peer adjacent in several spaces is
counted once) are precomputed host-side into dense per-slot weight
tables.  :func:`masked_mixing_matrix` is the dense oracle the tests hold
:func:`repro_torch.dist.sync.global_mixer` to.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .coords import NodeAddress
from .mep import ClientProfile, aggregation_weights
from .topology import fedlay_topology, ring_orders


@dataclasses.dataclass(frozen=True, eq=False)
class PermuteSchedule:
    """Everything :func:`repro_torch.dist.sync.global_mixer` needs, all
    host-side static.

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
                           salt: str = "") -> PermuteSchedule:
    """Compile a FedLay overlay over client positions 0..n-1 into the
    2L-rotation schedule.  Client identity = position; coordinates are
    hashed from it exactly as the paper hashes IP addresses.  (The
    reference's multi-pod ``pod_bias`` waits for ROADMAP.md Queue 1
    item 10.)"""
    addrs = [NodeAddress.create(i, num_spaces, salt) for i in range(num_clients)]
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
