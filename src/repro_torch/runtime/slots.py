"""Fixed-capacity slot allocation for static-shape training under churn.

The device data plane wants one shape forever: a leading client axis of
size ``capacity`` that never changes.  :class:`SlotMap` owns the mapping
between live NDMP node identities and those capacity slots:

* survivors **never move** — a node keeps its slot for its whole
  lifetime (identity-preserving, so membership changes are in-place row
  writes instead of host re-stacks);
* leavers free their slot (the row goes stale and is masked dead);
* joiners take the lowest free slot (deterministic, so two runs of the
  same churn trace produce the same layout).

:meth:`SlotMap.plan` computes the :class:`RemapPlan` for a new alive set
*without mutating* — the overlay controller stages plans during a
control step and applies them at the step boundary
(:meth:`repro.overlay.controller.OverlayController.commit`), which is
what makes the double-buffered swap race-free.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class SlotCapacityError(RuntimeError):
    """The alive set no longer fits in the fixed capacity."""


@dataclasses.dataclass(frozen=True)
class RemapPlan:
    """One membership reconciliation, expressed as slot operations.

    ``survivors``/``joiners``/``leavers`` are ``(node_id, slot)`` pairs;
    survivors keep the slot they already held, joiners name the slot
    they will be written into, leavers the slot they vacate.  A plan is
    pure data — nothing changes until :meth:`SlotMap.apply`.
    """

    capacity: int
    survivors: Tuple[Tuple[int, int], ...]
    joiners: Tuple[Tuple[int, int], ...]
    leavers: Tuple[Tuple[int, int], ...]

    @property
    def changed(self) -> bool:
        return bool(self.joiners or self.leavers)

    @property
    def slot_of(self) -> Dict[int, int]:
        """node id → slot for the post-plan alive set."""
        out = dict(self.survivors)
        out.update(self.joiners)
        return out


def plan_reset_slots(plan: RemapPlan) -> Tuple[int, ...]:
    """Slots whose per-slot auxiliary state (e.g. the wire codec's
    error-feedback residual, :class:`repro.runtime.loop.SlotTrainLoop`)
    must be zeroed when ``plan`` is applied: every joiner slot (the new
    occupant must not inherit the previous tenant's residual) and every
    leaver slot (a dead row's residual would otherwise be replayed if
    the slot is reused before any intervening join).  Sorted, deduped."""
    return tuple(sorted({s for _, s in plan.joiners}
                        | {s for _, s in plan.leavers}))


class SlotMap:
    """Node-identity → capacity-slot allocator with a free-slot heap."""

    def __init__(self, capacity: int, initial: Sequence[int] = ()):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._node_at: List[Optional[int]] = [None] * capacity
        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = list(range(capacity))
        heapq.heapify(self._free)
        for u in initial:
            self.alloc(u)

    # ---- queries ---------------------------------------------------------
    @property
    def slot_of(self) -> Dict[int, int]:
        """Live node id → slot (a copy; mutate via alloc/free/apply)."""
        return dict(self._slot_of)

    def node_at(self, slot: int) -> Optional[int]:
        """The node occupying ``slot``, or None if the slot is dead."""
        return self._node_at[slot]

    def nodes(self) -> Tuple[int, ...]:
        """Live node ids in slot order."""
        return tuple(u for u in self._node_at if u is not None)

    @property
    def num_free(self) -> int:
        """Free slots remaining (the serving plane's admission gate)."""
        return len(self._free)

    def alive_mask(self) -> np.ndarray:
        """(capacity,) float32 0/1 mask — 1 where the slot hosts a live
        node.  This is the on-device mask the masked local step and
        mask-aware mixers consume."""
        mask = np.zeros((self.capacity,), dtype=np.float32)
        for slot, node in enumerate(self._node_at):
            if node is not None:
                mask[slot] = 1.0
        return mask

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, node_id: int) -> bool:
        return node_id in self._slot_of

    # ---- mutation --------------------------------------------------------
    def alloc(self, node_id: int) -> int:
        """Assign ``node_id`` the lowest free slot."""
        if node_id in self._slot_of:
            raise ValueError(f"node {node_id} already holds slot "
                             f"{self._slot_of[node_id]}")
        if not self._free:
            raise SlotCapacityError(
                f"capacity {self.capacity} exhausted allocating node "
                f"{node_id}")
        slot = heapq.heappop(self._free)
        self._slot_of[node_id] = slot
        self._node_at[slot] = node_id
        return slot

    def free(self, node_id: int) -> int:
        """Release ``node_id``'s slot back to the free heap."""
        slot = self._slot_of.pop(node_id, None)
        if slot is None:
            raise KeyError(f"node {node_id} holds no slot")
        self._node_at[slot] = None
        heapq.heappush(self._free, slot)
        return slot

    # ---- remap planning --------------------------------------------------
    def plan(self, new_alive: Sequence[int]) -> RemapPlan:
        """The identity-preserving :class:`RemapPlan` taking the current
        occupancy to ``new_alive``.  Pure: the map is unchanged until
        :meth:`apply`.  Joiners are assigned lowest-slot-first in the
        order they appear in ``new_alive``."""
        new_ids = list(new_alive)
        new_set = set(new_ids)
        if len(new_set) != len(new_ids):
            raise ValueError("duplicate node ids in new alive set")
        survivors = tuple((u, s) for u, s in sorted(self._slot_of.items())
                          if u in new_set)
        leavers = tuple((u, s) for u, s in sorted(self._slot_of.items())
                        if u not in new_set)
        pool = sorted(self._free + [s for _, s in leavers])
        joiners: List[Tuple[int, int]] = []
        for u in new_ids:
            if u in self._slot_of:
                continue
            if not pool:
                raise SlotCapacityError(
                    f"capacity {self.capacity} cannot hold "
                    f"{len(new_ids)} alive nodes")
            joiners.append((u, pool.pop(0)))
        return RemapPlan(capacity=self.capacity, survivors=survivors,
                         joiners=tuple(joiners), leavers=leavers)

    def apply(self, plan: RemapPlan) -> None:
        """Mutate the map per ``plan`` (leavers freed, joiners placed)."""
        if plan.capacity != self.capacity:
            raise ValueError(
                f"plan is for capacity {plan.capacity}, map has "
                f"{self.capacity}")
        for u, s in plan.survivors:
            if self._slot_of.get(u) != s:
                raise ValueError(
                    f"stale plan: survivor {u} expected in slot {s}")
        for u, _ in plan.leavers:
            self.free(u)
        for u, s in plan.joiners:
            if self._node_at[s] is not None:
                raise ValueError(
                    f"stale plan: joiner slot {s} occupied by "
                    f"{self._node_at[s]}")
            self._free.remove(s)
            heapq.heapify(self._free)
            self._slot_of[u] = s
            self._node_at[s] = u

    def remap(self, new_alive: Sequence[int]) -> RemapPlan:
        """plan + apply in one call."""
        plan = self.plan(new_alive)
        self.apply(plan)
        return plan
