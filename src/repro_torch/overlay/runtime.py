"""Training under live churn: the controller driving the device data plane.

The port of ``repro/overlay/runtime.py``.  :class:`ChurnTrainLoop` runs
:func:`repro_torch.launch.steps.dfl_train_bundle`'s ``sync="none"`` step
(the per-client local step over the leading client axis, whatever its
length) and applies the :class:`~repro_torch.overlay.controller
.OverlayController`'s hot-swapped mixer between steps.  With
``OverlayController(fuse="flat")`` that mixer is one ``gather_mix``
launch over the raveled (alive, N) population.

This is the **re-stacking** loop: the client axis is as long as the
alive set, so every membership change builds a new stack.  Its
static-shape sibling, which writes rows in place instead, is
:class:`repro_torch.runtime.loop.SlotTrainLoop`.  Membership changes
remap state by *node identity*, not device slot:

* survivors carry their parameter and optimizer rows (and their data —
  batches are drawn from node-id-keyed streams) to their new position;
* joiners start from their highest-confidence surviving neighbour's
  model (:func:`joiner_donors`, the paper's Fig. 18 catch-up mechanism)
  with a fresh optimizer row;
* leavers' rows are dropped.

While a remap runs it holds the old stack and the new one; while the
flat mixer runs it holds the stack, its raveled copy and the round's
output, three (alive, N) buffers.  The reference's ``jit_local_step``
and ``trace_count`` have no counterpart (PyTorch runs eagerly).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mixing import PermuteSchedule
from ..dist.flat import tree_flatten, tree_map
from ..obs.events import get_telemetry
from ..obs.rounds import get_round_ledger
from .controller import ControlReport, OverlayController
from .events import ChurnTrace


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


@dataclasses.dataclass
class ChurnStepRecord:
    """One training step under the control plane."""

    step: int
    time: float
    num_alive: int
    loss: float
    swapped: bool
    cache_hit: bool
    joined: Tuple[int, ...]
    left: Tuple[int, ...]


def _stack(trees):
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _row(tree, i: int):
    return tree_map(lambda l: l[i], tree)


class ChurnTrainLoop:
    """Drive a DFL train bundle under a scripted or stochastic churn trace.

    ``make_params(node_id)`` builds one client's (unstacked) parameter
    tree on the device the loop runs on; ``make_batch(node_ids, step)``
    one stacked batch (a dict of tensors) for the current alive set,
    keyed by node identity so survivors keep their shard across remaps.
    ``local_step`` is the bundle's ``sync="none"`` step ``(params,
    opt_state, batch) -> (params, opt_state, metrics)`` over the stacked
    tree; the controller's mixer is applied to the params afterwards —
    the hot-swap seam.  An explicit ``ledger=`` is the round ledger the
    loop records into (default: the process ledger, none until enabled).
    """

    def __init__(self, controller: OverlayController, *,
                 local_step: Callable,
                 make_params: Callable[[int], object],
                 optimizer,
                 make_batch: Callable[[Sequence[int], int], Dict[str, torch.Tensor]],
                 step_time: float = 1.0,
                 ledger=None):
        self.controller = controller
        self.local_step = local_step
        self.optimizer = optimizer
        self.make_params = make_params
        self.make_batch = make_batch
        self.step_time = step_time
        self._ledger = ledger
        # dist.sync.round_bytes_per_client's memo
        self._bytes_cache: dict = {}

        self.assignment: Tuple[int, ...] = controller.alive
        per_client = [make_params(u) for u in self.assignment]
        self.params = _stack(per_client)
        self.opt_state = _stack([optimizer.init(p) for p in per_client])
        del per_client
        self._row_elems = sum(int(np.prod(l.shape[1:], dtype=np.int64))
                              for l in tree_flatten(self.params)[0])
        self.records: List[ChurnStepRecord] = []

    # ---- state surgery ---------------------------------------------------
    def client_params(self, node_id: int):
        """The (unstacked) current model of one live client, as views."""
        return _row(self.params, self.assignment.index(node_id))

    def _remap(self, report: ControlReport) -> Tuple[Tuple[int, ...],
                                                     Tuple[int, ...]]:
        """Re-stack params/opt rows for the new alive set."""
        old = self.assignment
        new = report.alive
        old_slot = {u: i for i, u in enumerate(old)}
        new_set = set(new)
        survivors = [u for u in new if u in old_slot]
        joiners = [u for u in new if u not in old_slot]
        left = tuple(u for u in old if u not in new_set)
        donors = (joiner_donors(self.controller.schedule, new, joiners,
                                survivors) if joiners else {})

        param_rows, opt_rows = [], []
        for u in new:
            if u in old_slot:
                i = old_slot[u]
                param_rows.append(_row(self.params, i))
                opt_rows.append(_row(self.opt_state, i))
            else:
                donor = donors.get(u)
                p = (_row(self.params, old_slot[donor]) if donor is not None
                     else self.make_params(u))
                param_rows.append(p)
                opt_rows.append(self.optimizer.init(p))
        params, opt_state = _stack(param_rows), _stack(opt_rows)
        del param_rows, opt_rows
        self.params, self.opt_state = params, opt_state
        self.assignment = new
        return tuple(joiners), left

    # ---- telemetry -------------------------------------------------------
    def _record_round(self, ledger, step: int, report, loss: float,
                      joined, left) -> None:
        from ..dist.sync import round_bytes_per_client
        ctl = self.controller
        n = len(self.assignment)
        wire, payload = round_bytes_per_client(
            self._bytes_cache, ctl.strategy, 4 * self._row_elems, n,
            codec=ctl.codec, num_spaces=ctl.schedule.num_spaces,
            clients_per_device=ctl.clients_per_device)
        ledger.record(
            round=step, time=report.time, loop="churn",
            num_alive=n, participating=n, loss=loss,
            wire_bytes_per_client=wire, payload_bytes_per_client=payload,
            swapped=report.swapped, rebuilt=report.rebuilt,
            cache_hit=report.cache_hit, joined=joined, left=left,
            repair_ms=report.rebuild_ms, commit_ms=ctl.last_commit_ms)

    # ---- the loop --------------------------------------------------------
    def run(self, num_steps: int,
            trace: Optional[ChurnTrace] = None) -> List[ChurnStepRecord]:
        """``num_steps`` training steps, one control interval each (the
        step index handed to ``make_batch`` counts from 0 in every call,
        as the reference's does)."""
        for step in range(num_steps):
            report = self.controller.step(self.step_time, trace=trace)
            # land any staged swap before touching state (no-op unless
            # the controller is double_buffered) — report.alive and the
            # mixer must describe the same epoch
            self.controller.commit()
            joined, left = ((), ())
            if report.alive != self.assignment:
                joined, left = self._remap(report)
            batch = self.make_batch(self.assignment, step)
            params, opt_state, metrics = self.local_step(
                self.params, self.opt_state, batch)
            # the hot-swap seam: whatever mixer the controller holds now;
            # the pre-mixing stack is dropped before the next local step
            self.params = self.controller.mixer(params)
            del params
            self.opt_state = opt_state
            loss = float(metrics["loss"])
            self.records.append(ChurnStepRecord(
                step=step, time=report.time, num_alive=len(self.assignment),
                loss=loss, swapped=report.swapped, cache_hit=report.cache_hit,
                joined=joined, left=left))
            bus = get_telemetry()
            if bus.enabled:
                bus.count("churn.steps")
                bus.gauge("churn.num_alive", len(self.assignment))
                if joined or left:
                    bus.count("churn.remaps")
            ledger = self._ledger if self._ledger is not None else get_round_ledger()
            if ledger is not None:
                self._record_round(ledger, step, report, loss, joined, left)
        return self.records
