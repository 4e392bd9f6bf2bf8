"""Baseline overlay topologies the paper compares against (Table I, §II-C, §IV).

A copy of ``repro/core/baselines.py`` (numpy; :func:`delaunay` imports
scipy when it is called, as the reference's does).

Every constructor returns a :class:`~repro_torch.core.topology.Topology`
over nodes ``0..n-1`` so they are directly comparable under
:func:`~repro_torch.core.metrics.evaluate_topology` and usable as the
overlay of a gossip method of :mod:`repro_torch.core.dfl`.

Included: ring, dynamic chain, 2D grid, torus, hypercube, complete
graph, d-cliques, Chord, Viceroy-like constant-degree butterfly,
Waxman, distributed-Delaunay-triangulation (2D), a social-network proxy
(Barabási–Albert preferential attachment — same heavy-tail degree
family as the Facebook ego graph the paper samples), and random
d-regular graphs incl. the paper's "Best of 100" procedure.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .coords import NodeAddress
from .metrics import evaluate_topology
from .topology import Topology, fedlay_topology, make_edge


# --------------------------------------------------------------------------
# Simple fixed topologies (He et al. / Vogels et al. baselines)
# --------------------------------------------------------------------------

def ring(n: int) -> Topology:
    edges = {make_edge(i, (i + 1) % n) for i in range(n)} if n > 1 else set()
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="ring")


def chain(n: int) -> Topology:
    """The (static snapshot of the) GADMM dynamic chain: a path graph."""
    edges = {make_edge(i, i + 1) for i in range(n - 1)}
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="chain")


def grid_2d(n: int) -> Topology:
    """2D grid on ⌈√n⌉ columns (non-wrap)."""
    cols = int(math.ceil(math.sqrt(n)))
    edges = set()
    for i in range(n):
        r, c = divmod(i, cols)
        if c + 1 < cols and i + 1 < n:
            edges.add(make_edge(i, i + 1))
        if (r + 1) * cols + c < n:
            edges.add(make_edge(i, (r + 1) * cols + c))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="grid2d")


def torus(n: int) -> Topology:
    """2D torus (wrap-around grid), degree 4."""
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    # use exactly rows*cols >= n; wrap edges only valid on full rectangle,
    # so clamp n to rows*cols by reusing modulo indexing over n.
    edges = set()
    for i in range(n):
        r, c = divmod(i, cols)
        right = r * cols + (c + 1) % cols
        down = ((r + 1) % rows) * cols + c
        for j in (right, down):
            j = j % n
            if j != i:
                edges.add(make_edge(i, j))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="torus")


def hypercube(n: int) -> Topology:
    """Hypercube over the smallest 2^k ≥ n, folded onto n nodes (mod n)."""
    k = max(1, int(math.ceil(math.log2(max(2, n)))))
    edges = set()
    for i in range(n):
        for b in range(k):
            j = (i ^ (1 << b)) % n
            if j != i:
                edges.add(make_edge(i, j))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="hypercube")


def complete_graph(n: int) -> Topology:
    edges = {make_edge(i, j) for i in range(n) for j in range(i + 1, n)}
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="complete")


def d_cliques(n: int, clique_size: int = 10) -> Topology:
    """D-Cliques-style topology: dense intra-clique + a ring of cliques."""
    edges = set()
    num_cliques = max(1, math.ceil(n / clique_size))
    cliques: List[List[int]] = [[] for _ in range(num_cliques)]
    for i in range(n):
        cliques[i // clique_size].append(i)
    for members in cliques:
        for a in range(len(members)):
            for b in range(a + 1, len(members)):
                edges.add(make_edge(members[a], members[b]))
    for ci in range(num_cliques):
        nxt = (ci + 1) % num_cliques
        if nxt != ci and cliques[ci] and cliques[nxt]:
            edges.add(make_edge(cliques[ci][0], cliques[nxt][0]))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="dcliques")


# --------------------------------------------------------------------------
# P2P / DHT overlays
# --------------------------------------------------------------------------

def chord(n: int) -> Topology:
    """Chord ring with finger tables: node i links to (i + 2^k) mod n.

    Degree ≈ 2 log₂ n as in the paper's comparison."""
    edges = set()
    k_max = max(1, int(math.ceil(math.log2(max(2, n)))))
    for i in range(n):
        for k in range(k_max):
            j = (i + (1 << k)) % n
            if j != i:
                edges.add(make_edge(i, j))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="chord")


def viceroy(n: int, rng: Optional[np.random.Generator] = None) -> Topology:
    """Constant-degree butterfly-style overlay in the spirit of Viceroy.

    Each node picks a level ℓ ∈ {1..log n}; ring edges over all nodes,
    level rings, and butterfly down-links to ~position·2 at level ℓ+1.
    This reproduces Viceroy's qualitative profile the paper reports:
    decent spectral properties but long paths at constant degree.
    """
    rng = rng or np.random.default_rng(0)
    levels = max(1, int(round(math.log2(max(2, n)))))
    lvl = rng.integers(1, levels + 1, size=n)
    edges = set()
    for i in range(n):  # global ring (successor links)
        if n > 1:
            edges.add(make_edge(i, (i + 1) % n))
    # butterfly links: to approx double/half position among next level
    order = np.argsort(rng.random(n))  # virtual ring positions
    pos = np.empty(n)
    pos[order] = np.arange(n) / n
    for i in range(n):
        if lvl[i] < levels:
            targets = [j for j in range(n) if lvl[j] == lvl[i] + 1]
            if targets:
                for t_pos in ((pos[i] * 2) % 1.0, (pos[i] * 2 + 1.0 / (1 << int(lvl[i]))) % 1.0):
                    j = min(targets, key=lambda j: abs(pos[j] - t_pos))
                    if j != i:
                        edges.add(make_edge(i, j))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="viceroy")


# --------------------------------------------------------------------------
# Geometric overlays
# --------------------------------------------------------------------------

def waxman(n: int, alpha: float = 0.25, beta: float = 0.4,
           rng: Optional[np.random.Generator] = None) -> Topology:
    """Waxman random geometric graph: P(u~v) = β·exp(-d(u,v)/(α·d_max))."""
    rng = rng or np.random.default_rng(0)
    pts = rng.random((n, 2))
    dmax = math.sqrt(2.0)
    edges = set()
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.linalg.norm(pts[i] - pts[j]))
            if rng.random() < beta * math.exp(-d / (alpha * dmax)):
                edges.add(make_edge(i, j))
    topo = Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="waxman")
    return _ensure_connected_ring(topo)


def delaunay(n: int, rng: Optional[np.random.Generator] = None) -> Topology:
    """Distributed Delaunay triangulation overlay on random 2D points."""
    from scipy.spatial import Delaunay as _Delaunay

    rng = rng or np.random.default_rng(0)
    pts = rng.random((n, 2))
    tri = _Delaunay(pts)
    edges = set()
    for simplex in tri.simplices:
        a, b, c = (int(x) for x in simplex)
        edges.add(make_edge(a, b))
        edges.add(make_edge(b, c))
        edges.add(make_edge(a, c))
    return Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="delaunay")


def social(n: int, m: int = 3, rng: Optional[np.random.Generator] = None) -> Topology:
    """Barabási–Albert preferential-attachment proxy for the Facebook
    ego-network sample the paper uses (heavy-tail degrees, high clustering
    relative to RRGs)."""
    rng = rng or np.random.default_rng(0)
    edges = set()
    targets = list(range(m))
    repeated: List[int] = list(range(m))
    for v in range(m, n):
        chosen: set = set()
        while len(chosen) < min(m, len(set(repeated))):
            chosen.add(int(repeated[rng.integers(len(repeated))]))
        for u in chosen:
            edges.add(make_edge(u, v))
            repeated.extend((u, v))
    topo = Topology(nodes=tuple(range(n)), edges=frozenset(edges), name="social")
    return _ensure_connected_ring(topo)


# --------------------------------------------------------------------------
# Random regular graphs — the paper's "Best of 100" reference
# --------------------------------------------------------------------------

def random_regular(n: int, d: int, rng: Optional[np.random.Generator] = None,
                   max_tries: int = 200) -> Topology:
    """Random d-regular simple graph via the configuration model with
    retry-on-collision (standard near-uniform sampler)."""
    if (n * d) % 2 != 0:
        raise ValueError("n*d must be even for a d-regular graph")
    if d >= n:
        raise ValueError("degree must be < n")
    rng = rng or np.random.default_rng(0)
    for _ in range(max_tries):
        stubs = np.repeat(np.arange(n), d)
        rng.shuffle(stubs)
        pairs = [[int(stubs[i]), int(stubs[i + 1])]
                 for i in range(0, len(stubs), 2)]
        # repair self-loops / duplicate edges by random edge swaps (the
        # standard fix: a raw configuration-model draw at d≥4 almost
        # always has a few collisions)
        for _ in range(50 * len(pairs)):
            seen = set()
            bad = None
            for idx, (a, b) in enumerate(pairs):
                e = (min(a, b), max(a, b))
                if a == b or e in seen:
                    bad = idx
                    break
                seen.add(e)
            if bad is None:
                edges = frozenset(make_edge(a, b) for a, b in pairs)
                return Topology(nodes=tuple(range(n)), edges=edges,
                                name=f"rrg-d{d}")
            j = int(rng.integers(len(pairs)))
            if j == bad:
                continue
            a, b = pairs[bad]
            c, e2 = pairs[j]
            pairs[bad], pairs[j] = [a, c], [b, e2]
    raise RuntimeError("failed to sample a simple d-regular graph")


def best_of_rrgs(n: int, d: int, trials: int = 100, metric: str = "convergence_factor",
                 seed: int = 0) -> Topology:
    """The paper's "Best" baseline: generate ``trials`` random d-regular
    graphs (centralized!) and keep the best under ``metric``."""
    best_topo, best_val = None, float("inf")
    for t in range(trials):
        topo = random_regular(n, d, rng=np.random.default_rng(seed + t))
        rep = evaluate_topology(topo)
        val = getattr(rep, metric)
        if val < best_val:
            best_topo, best_val = topo, val
    assert best_topo is not None
    return Topology(nodes=best_topo.nodes, edges=best_topo.edges, name=f"best100-d{d}")


def fedlay(n: int, num_spaces: int, salt: str = "") -> Topology:
    """The FedLay topology for n synthetic clients (degree ≤ 2·num_spaces)."""
    addrs = [NodeAddress.create(i, num_spaces, salt) for i in range(n)]
    topo = fedlay_topology(addrs, name=f"fedlay-L{num_spaces}")
    return topo


def _ensure_connected_ring(topo: Topology) -> Topology:
    """Random graphs (Waxman/BA) can be disconnected at small n; patch with
    a thin ring so metrics are finite — noted in benchmarks."""
    if topo.is_connected():
        return topo
    edges = set(topo.edges)
    nodes = list(topo.nodes)
    for i in range(len(nodes)):
        edges.add(make_edge(nodes[i], nodes[(i + 1) % len(nodes)]))
    return Topology(nodes=topo.nodes, edges=frozenset(edges), name=topo.name)


TOPOLOGY_REGISTRY: Dict[str, Callable[..., Topology]] = {
    "ring": ring,
    "chain": chain,
    "grid2d": grid_2d,
    "torus": torus,
    "hypercube": hypercube,
    "complete": complete_graph,
    "dcliques": d_cliques,
    "chord": chord,
    "viceroy": viceroy,
    "waxman": waxman,
    "delaunay": delaunay,
    "social": social,
    "fedlay": fedlay,
}
