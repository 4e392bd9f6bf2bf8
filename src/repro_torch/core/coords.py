"""Virtual coordinates and circular distance (paper §II-C, Definition 2).

A copy of ``repro/core/coords.py``, trimmed to what the DFL round
calls.  Every FedLay node derives an L-dimensional virtual coordinate
vector ``⟨x_1, .., x_L⟩`` with each ``x_i ∈ [0, 1)``: the stable 64-bit
FNV-1a hash of ``"{node_id}|{i}"`` (with a murmur3 finalizer) mapped
into [0, 1), bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses

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
    """The node's virtual coordinate in ring space ``space`` (paper: H(IP|i)),
    a float in [0, 1)."""
    h = fnv1a_64(f"{salt}{node_id}|{space}".encode())
    return (h >> 11) / float(1 << 53)  # 53-bit mantissa-exact uniform


def coordinates(node_id: object, num_spaces: int, salt: str = "") -> tuple:
    """The full L-dimensional coordinate vector of a node."""
    return tuple(coordinate(node_id, i, salt) for i in range(num_spaces))


def circular_distance(x: float, y: float) -> float:
    """Definition 2: CD(x, y) = min(|x - y|, 1 - |x - y|)."""
    d = abs(x - y)
    return min(d, 1.0 - d)


@dataclasses.dataclass(frozen=True)
class NodeAddress:
    """Identity + coordinates of a FedLay node.  ``node_id`` doubles as
    the paper's IP address for tie-breaking: it must be orderable and
    unique."""

    node_id: int
    coords: tuple

    @property
    def num_spaces(self) -> int:
        return len(self.coords)

    @classmethod
    def create(cls, node_id: int, num_spaces: int, salt: str = "") -> "NodeAddress":
        return cls(node_id=node_id, coords=coordinates(node_id, num_spaces, salt))

