"""The three DFL topology metrics of paper §II-B.

1. *Convergence factor* ``c_G = 1 / (1 - λ)²`` with
   ``λ = max(|λ₂(M)|, |λ_N(M)|)`` of a symmetric doubly-stochastic
   mixing matrix M of the graph (we use the Metropolis–Hastings matrix,
   as the paper does, citing Boyd–Diaconis–Xiao).
2. *Diameter* — longest shortest path.
3. *Average shortest-path length*.

All are exact (dense eigensolve + BFS); the paper evaluates n ≤ 1000
where this is trivially cheap.

A copy of ``repro/core/metrics.py`` (pure numpy).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .topology import Topology


def metropolis_hastings_matrix(A: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings mixing matrix of an adjacency matrix.

    M[i,j] = 1 / (1 + max(d_i, d_j)) for edges, M[i,i] = 1 - Σ_j M[i,j].
    Symmetric, doubly stochastic, and valid for irregular degrees —
    which is exactly why the paper uses it (FedLay nodes can have
    degree < 2L when a peer is adjacent in several spaces).
    """
    n = A.shape[0]
    deg = A.sum(axis=1)
    M = np.zeros_like(A, dtype=np.float64)
    ii, jj = np.nonzero(A)
    M[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    M[np.arange(n), np.arange(n)] = 1.0 - M.sum(axis=1)
    return M


def uniform_mixing_matrix(A: np.ndarray) -> np.ndarray:
    """Equal-weight aggregation over {u} ∪ N_u (DFedAvg simple average).

    Row-stochastic but only symmetric for regular graphs; provided for
    the MEP ablation (confidence weighting vs simple average).
    """
    n = A.shape[0]
    W = A + np.eye(n)
    return W / W.sum(axis=1, keepdims=True)


def spectral_lambda(M: np.ndarray) -> float:
    """λ(M) = max(|λ₂|, |λ_N|) for a symmetric mixing matrix."""
    if M.shape[0] < 2:
        return 0.0
    if not np.allclose(M, M.T, atol=1e-10):
        # Fall back to singular values for non-symmetric mixing matrices.
        s = np.linalg.svd(M - np.ones_like(M) / M.shape[0], compute_uv=False)
        return float(s[0])
    ev = np.sort(np.linalg.eigvalsh(M))  # ascending
    return float(max(abs(ev[0]), abs(ev[-2])))


def convergence_factor(topology: Topology, mixing: str = "metropolis") -> float:
    """c_G = 1 / (1 - λ)² (paper §II-B1). Infinite for disconnected graphs."""
    A = topology.adjacency()
    M = metropolis_hastings_matrix(A) if mixing == "metropolis" else uniform_mixing_matrix(A)
    lam = spectral_lambda(M)
    if lam >= 1.0 - 1e-12:
        return float("inf")
    return 1.0 / (1.0 - lam) ** 2


def generalization_gap_bound(lam: float) -> float:
    """O(2λ² + 4λ² ln(1/λ) + 2λ + 2/ln(1/λ)) — the paper's second bound.

    Increasing in λ on (0,1), so minimizing c_G also minimizes this;
    exposed for completeness / tests."""
    if lam <= 0.0:
        return 0.0
    if lam >= 1.0:
        return float("inf")
    ln_inv = np.log(1.0 / lam)
    return float(2 * lam**2 + 4 * lam**2 * ln_inv + 2 * lam + 2.0 / ln_inv)


def _bfs_dists(nbr: Dict[int, List[int]], src: int) -> Dict[int, int]:
    dist = {src: 0}
    q = deque([src])
    while q:
        u = q.popleft()
        for v in nbr[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def shortest_path_stats(topology: Topology) -> "PathStats":
    """Diameter and average shortest-path length via all-pairs BFS."""
    nbr = topology.neighbor_map()
    n = topology.n
    if n < 2:
        return PathStats(diameter=0, avg_shortest_path=0.0, connected=True)
    diameter = 0
    total = 0
    pairs = 0
    for u in topology.nodes:
        dist = _bfs_dists(nbr, u)
        if len(dist) != n:
            return PathStats(diameter=-1, avg_shortest_path=float("inf"), connected=False)
        for v, d in dist.items():
            if v > u:
                total += d
                pairs += 1
                diameter = max(diameter, d)
    return PathStats(diameter=diameter, avg_shortest_path=total / pairs, connected=True)


@dataclasses.dataclass(frozen=True)
class PathStats:
    diameter: int
    avg_shortest_path: float
    connected: bool


@dataclasses.dataclass(frozen=True)
class TopologyReport:
    """All three §II-B metrics for one topology."""

    name: str
    n: int
    avg_degree: float
    max_degree: int
    spectral_lambda: float
    convergence_factor: float
    diameter: int
    avg_shortest_path: float
    connected: bool


def evaluate_topology(topology: Topology, mixing: str = "metropolis") -> TopologyReport:
    A = topology.adjacency()
    deg = A.sum(axis=1)
    M = metropolis_hastings_matrix(A) if mixing == "metropolis" else uniform_mixing_matrix(A)
    lam = spectral_lambda(M)
    cf = float("inf") if lam >= 1.0 - 1e-12 else 1.0 / (1.0 - lam) ** 2
    ps = shortest_path_stats(topology)
    return TopologyReport(
        name=topology.name,
        n=topology.n,
        avg_degree=float(deg.mean()) if topology.n else 0.0,
        max_degree=int(deg.max()) if topology.n else 0,
        spectral_lambda=lam,
        convergence_factor=cf,
        diameter=ps.diameter,
        avg_shortest_path=ps.avg_shortest_path,
        connected=ps.connected,
    )
