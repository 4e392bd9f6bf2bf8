"""Virtual coordinates and circular distance (paper §II-C, Definition 2).

A copy of ``repro/core/coords.py``.  Every FedLay node derives an
L-dimensional virtual coordinate vector ``⟨x_1, .., x_L⟩`` with each
``x_i ∈ [0, 1)``: the stable 64-bit FNV-1a hash of ``"{node_id}|{i}"``
(with a murmur3 finalizer) mapped into [0, 1), bit for bit the
reference's.  :func:`coordinates_batch` hashes many ids at once in
numpy, bit-exact with :func:`coordinate`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fmix64(h: int) -> int:
    """Murmur3 64-bit finalizer — full avalanche so that inputs differing
    in one trailing byte (e.g. "7|0" vs "7|1") map to independent points."""
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _MASK64
    h ^= h >> 33
    return h


def fnv1a_64(data: bytes) -> int:
    """Stable 64-bit hash (FNV-1a + murmur finalizer), deterministic
    across runs and platforms (the paper's "publicly known hash H")."""
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return _fmix64(h)


def coordinate(node_id: object, space: int, salt: str = "") -> float:
    """The node's virtual coordinate in ring space ``space`` (paper: H(IP|i)).

    Returns a float in [0, 1).  ``salt`` lets tests / simulations draw
    independent coordinate systems for repeated trials.
    """
    h = fnv1a_64(f"{salt}{node_id}|{space}".encode())
    return (h >> 11) / float(1 << 53)  # 53-bit mantissa-exact uniform


def coordinates(node_id: object, num_spaces: int, salt: str = "") -> tuple:
    """The full L-dimensional coordinate vector of a node."""
    return tuple(coordinate(node_id, i, salt) for i in range(num_spaces))


def coordinates_batch(node_ids: Sequence[int], num_spaces: int,
                      salt: str = "") -> "np.ndarray":
    """(n, L) float64 coordinate matrix, bit-exact vs :func:`coordinate`.

    Vectorizes the FNV-1a byte loop over a padded byte matrix: every
    hash input ``f"{salt}{id}|{space}"`` is expanded to the same width,
    and the per-byte ``h = (h ^ b) * prime`` update runs across all
    rows at once in uint64 (numpy wraps at 2^64 exactly like the
    scalar ``& _MASK64``).  Padding columns are handled by masking:
    rows shorter than the width keep their running hash unchanged on
    the columns past their own length.  This is what lets the
    vectorized NDMP engine hash 10^5–10^6 node coordinates in
    milliseconds instead of minutes.
    """
    ids = list(node_ids)
    n = len(ids)
    out = np.empty((n, num_spaces), dtype=np.float64)
    if n == 0:
        return out
    prime = np.uint64(_FNV_PRIME)
    for space in range(num_spaces):
        keys = [f"{salt}{u}|{space}".encode() for u in ids]
        width = max(len(k) for k in keys)
        mat = np.zeros((n, width), dtype=np.uint64)
        lens = np.empty((n,), dtype=np.int64)
        for r, k in enumerate(keys):
            lens[r] = len(k)
            mat[r, :len(k)] = np.frombuffer(k, dtype=np.uint8)
        h = np.full((n,), _FNV_OFFSET, dtype=np.uint64)
        cols = np.arange(width)
        for c in range(width):
            live = lens > cols[c]
            h = np.where(live, (h ^ mat[:, c]) * prime, h)
        # murmur3 fmix64 finalizer, elementwise
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xC4CEB9FE1A85EC53)
        h ^= h >> np.uint64(33)
        out[:, space] = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return out


def circular_distance(x: float, y: float) -> float:
    """Definition 2: CD(x, y) = min(|x - y|, 1 - |x - y|).

    The length of the smaller arc between two ring positions, with the
    ring perimeter normalized to 1.
    """
    d = abs(x - y)
    return min(d, 1.0 - d)


def ccw_arc(src: float, dst: float) -> float:
    """Arc length travelling counterclockwise (decreasing coordinate,
    wrapping 0 → 1) from ``src`` to ``dst``.

    We adopt the convention that coordinates increase clockwise, so the
    counterclockwise arc from x to y has length ``(x - y) mod 1``.
    """
    return (src - dst) % 1.0


def cw_arc(src: float, dst: float) -> float:
    """Arc length travelling clockwise (increasing coordinate) src → dst."""
    return (dst - src) % 1.0


def closer(x: float, y: float, target: float, tie_x: int = 0, tie_y: int = 0) -> bool:
    """True iff x is strictly closer to ``target`` than y on the ring.

    Ties in circular distance are broken by the smaller tie value
    (paper: smaller IP address wins), so exactly one node is closest to
    any coordinate.
    """
    dx, dy = circular_distance(x, target), circular_distance(y, target)
    if dx != dy:
        return dx < dy
    return tie_x < tie_y


@dataclasses.dataclass(frozen=True)
class NodeAddress:
    """Identity + coordinates of a FedLay node.

    ``node_id`` doubles as the paper's IP address for tie-breaking: it
    must be orderable and unique.
    """

    node_id: int
    coords: tuple

    @property
    def num_spaces(self) -> int:
        return len(self.coords)

    @classmethod
    def create(cls, node_id: int, num_spaces: int, salt: str = "") -> "NodeAddress":
        return cls(node_id=node_id, coords=coordinates(node_id, num_spaces, salt))


def ring_order(addrs: Sequence[NodeAddress], space: int) -> list:
    """Node ids sorted by coordinate in ``space`` (clockwise ring order).

    Identical coordinates are ordered by node id (the paper's IP-address
    tie-break)."""
    return [a.node_id for a in sorted(addrs, key=lambda a: (a.coords[space], a.node_id))]
