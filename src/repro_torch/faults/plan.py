"""Data-plane faults and their edge mask.

A copy of :class:`DataFaults` and :func:`edge_mask_for` from
``repro/faults/plan.py``, which the slot runtime imports
(``repro/runtime/loop.py:36``).  The fault plans and the chaos engine
that produces these snapshots wait for ROADMAP.md Queue 1 item 6; until
then :class:`repro_torch.runtime.loop.SlotTrainLoop` reads a snapshot
from any simulator that offers ``data_faults()``.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataFaults:
    """Data-plane faults active at one instant.

    ``down_pairs`` holds undirected ``(min, max)`` node-id pairs,
    ``slow_nodes`` the straggling node ids, and ``groups`` the groups
    of the active partition (``None`` when whole).  The data-plane
    mask is always symmetric — if either endpoint cannot complete the
    exchange, the edge is down for both.
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

    ``sched`` is a :class:`repro_torch.core.mixing.PermuteSchedule` (or
    any object with ``(K, C)`` ``perms``) in *slot* space;
    ``slot_nodes[i]`` is the node id occupying slot ``i`` (``None`` for
    empty slots — their edges are left at 1, the alive mask already
    removes them).  Entry ``[i, k]`` is 0 when the edge between slot
    ``i`` and its k-th incoming slot ``perms[k][i]`` is unreachable.
    Feed the result to the masked mixers' keyword-only ``edge_mask``."""
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
