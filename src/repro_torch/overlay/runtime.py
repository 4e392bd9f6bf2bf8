"""Joiner donors: the paper's Fig. 18 catch-up rule.

A copy of :func:`joiner_donors` from ``repro/overlay/runtime.py``;
its ``ChurnTrainLoop`` (the re-stacking loop) waits for ROADMAP.md
Queue 1 item 6.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..core.mixing import PermuteSchedule


def joiner_donors(sched: PermuteSchedule, alive: Sequence[int],
                  joiners: Sequence[int],
                  survivors: Sequence[int]) -> Dict[int, Optional[int]]:
    """For each joiner, its highest-confidence *surviving* neighbor under
    the new schedule (paper Fig. 18: new nodes catch up by starting from
    a high-confidence existing model).  None when every neighbor is
    itself a joiner (fresh-init fallback)."""
    slot_of = {u: i for i, u in enumerate(alive)}
    survivor_set = set(survivors)
    out: Dict[int, Optional[int]] = {}
    for j in joiners:
        i = slot_of[j]
        best, best_w = None, 0.0
        for k in range(sched.num_slots):
            src = alive[sched.perms[k][i]]
            w = float(sched.weights[i, k])
            if src in survivor_set and w > best_w:
                best, best_w = src, w
        out[j] = best
    return out
