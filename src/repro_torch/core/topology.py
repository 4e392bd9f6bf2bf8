"""FedLay overlay topology (paper §II-C) and the Definition-1 correctness test.

A copy of ``repro/core/topology.py``.

A FedLay overlay over a node set is fully determined by the nodes'
virtual coordinates: in each of the L ring spaces every node is adjacent
to its predecessor and successor in coordinate order, and its overlay
neighbor set is the union of ring adjacencies over all spaces (at most
2L neighbors; fewer when the same peer is adjacent in several spaces).

This module holds the *static* graph math — building the ideal topology
from coordinates, adjacency queries, and Definition-1 correctness
checking of a (possibly damaged) neighbor-table state.  The *dynamic*
construction/maintenance protocols that converge to this topology live
in :mod:`repro_torch.core.ndmp`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

import numpy as np

from .coords import NodeAddress


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected overlay graph G = (V, E) with node metadata."""

    nodes: Tuple[int, ...]
    edges: FrozenSet[Tuple[int, int]]  # canonical (min, max) pairs
    name: str = "graph"

    # ---- basic graph API -------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.nodes)

    def neighbors(self, u: int) -> List[int]:
        out = []
        for a, b in self.edges:
            if a == u:
                out.append(b)
            elif b == u:
                out.append(a)
        return sorted(out)

    def neighbor_map(self) -> Dict[int, List[int]]:
        nbr: Dict[int, List[int]] = {u: [] for u in self.nodes}
        for a, b in self.edges:
            nbr[a].append(b)
            nbr[b].append(a)
        return {u: sorted(v) for u, v in nbr.items()}

    def degrees(self) -> Dict[int, int]:
        return {u: len(v) for u, v in self.neighbor_map().items()}

    def adjacency(self) -> np.ndarray:
        """Dense 0/1 adjacency matrix in ``self.nodes`` order."""
        index = {u: i for i, u in enumerate(self.nodes)}
        A = np.zeros((self.n, self.n), dtype=np.float64)
        for a, b in self.edges:
            A[index[a], index[b]] = 1.0
            A[index[b], index[a]] = 1.0
        return A

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        nbr = self.neighbor_map()
        seen = {self.nodes[0]}
        stack = [self.nodes[0]]
        while stack:
            u = stack.pop()
            for v in nbr[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == self.n


def make_edge(u: int, v: int) -> Tuple[int, int]:
    if u == v:
        raise ValueError(f"self-loop on node {u}")
    return (u, v) if u < v else (v, u)


def ring_adjacent(addrs: Sequence[NodeAddress], space: int) -> List[Tuple[int, int]]:
    """Ring-adjacency pairs in one virtual space (clockwise order edges)."""
    order = sorted(addrs, key=lambda a: (a.coords[space], a.node_id))
    n = len(order)
    if n < 2:
        return []
    if n == 2:
        return [make_edge(order[0].node_id, order[1].node_id)]
    return [make_edge(order[i].node_id, order[(i + 1) % n].node_id) for i in range(n)]


def fedlay_topology(addrs: Sequence[NodeAddress], name: str = "fedlay") -> Topology:
    """The correct FedLay overlay (Definition 1) for a set of addresses."""
    if not addrs:
        return Topology(nodes=(), edges=frozenset(), name=name)
    num_spaces = addrs[0].num_spaces
    edges = set()
    for s in range(num_spaces):
        edges.update(ring_adjacent(addrs, s))
    return Topology(nodes=tuple(sorted(a.node_id for a in addrs)), edges=frozenset(edges), name=name)


def correct_neighbor_sets(addrs: Sequence[NodeAddress]) -> Dict[int, FrozenSet[int]]:
    """Definition 1: for every node, the set of ring-adjacent nodes over all spaces."""
    topo = fedlay_topology(addrs)
    nbr = topo.neighbor_map()
    return {u: frozenset(v) for u, v in nbr.items()}


def correctness(
    neighbor_tables: Dict[int, Iterable[int]], addrs: Sequence[NodeAddress]
) -> float:
    """Topology correctness metric (paper §IV-A3).

    ``number of correct neighbor entries / total required neighbor
    entries`` over all nodes, where the required entries are the
    Definition-1 neighbor sets.  1.0 ⇔ a correct FedLay (every node has
    exactly its ring-adjacent peers; extra stale entries also count
    against correctness).
    """
    want = correct_neighbor_sets(addrs)
    total = sum(len(w) for w in want.values())
    if total == 0:
        return 1.0
    got_correct = 0
    extra = 0
    for u, w in want.items():
        have = frozenset(neighbor_tables.get(u, ()))
        got_correct += len(have & w)
        extra += len(have - w)
    return got_correct / (total + extra) if (total + extra) else 1.0


def ring_orders(addrs: Sequence[NodeAddress]) -> List[List[int]]:
    """Clockwise node-id order per virtual space — the static schedule the
    distribution layer compiles into ``ppermute`` rotations."""
    if not addrs:
        return []
    num_spaces = addrs[0].num_spaces
    return [
        [a.node_id for a in sorted(addrs, key=lambda a: (a.coords[s], a.node_id))]
        for s in range(num_spaces)
    ]
