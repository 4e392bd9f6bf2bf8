"""The slot runtime: DFL training on a fixed-capacity client axis.

The port of ``repro/runtime/loop.py:SlotTrainLoop``.  The loop trains
against a **fixed-capacity** client axis, whatever the membership does:

* the :class:`~repro_torch.overlay.controller.OverlayController` runs in
  capacity mode (it owns the :class:`~repro_torch.runtime.slots.SlotMap`,
  pads rebuilt schedules so dead slots self-loop with weight 1, and
  builds mask-aware mixers ``(params, mask) -> params``);
* membership changes become **in-place row writes** at the round
  boundary: a joiner is written into its slot (a copy of its
  highest-confidence surviving neighbor, the paper's Fig. 18 catch-up,
  or a fresh init when every neighbor is itself a joiner); a leaver's
  row just goes dead in the mask;
* the local step is mask-aware (``(params, opt_state, batch, mask)``,
  e.g. :func:`repro_torch.launch.steps.dfl_local_step` or
  :func:`repro_torch.runtime.masked.masked_local_step`);
* multirate participation (``periods``) rides the mixing mask.

The reference's counterpart of "zero retraces" is **zero reallocation**
here: the population, the mixer's output buffer and the optimizer state
are allocated once, when the loop is built, and keep their storage for
the whole run (what each step or mixer returns is written into them).
The loop needs an ``OverlayController(flat_io=True)``: the population is
one resident (capacity, N) flat buffer
(:class:`repro_torch.dist.flat.FlatSpec`), and the local step sees a
tree of views into it; the mixer writes the round into the second
buffer and the two swap roles every round.  The reference's other mode,
a resident parameter tree, waits for the slice whose path needs it.

Checkpointing (``save`` / ``restore``) waits for ROADMAP.md Queue 1
item 5, and wire codecs for item 7.  A simulator that offers
``data_faults()`` (the reference's chaos engine, Queue 1 item 6) turns
on degraded rounds through the mixer's ``edge_mask``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mixing import multirate_participation
from ..dist.flat import FlatSpec, tree_flatten, tree_map
from ..faults.plan import edge_mask_for
from ..obs.events import get_telemetry
from ..obs.rounds import get_round_ledger, round_ledger
from ..overlay.controller import OverlayController
from ..overlay.events import ChurnTrace
from ..overlay.runtime import joiner_donors
from .slots import RemapPlan

#: Simulated seconds of NDMP time one training round advances.
ROUND_TIME = 1.0


def _store(dst, src) -> None:
    """Copy a tree into a resident tree of the same structure, leaf by
    leaf, skipping leaves that already are the destination."""
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        if s.data_ptr() != d.data_ptr():
            d.copy_(s)


def _stacked(row_tree, capacity: int):
    """A (capacity, ...) copy of every leaf of a per-client tree."""
    return tree_map(lambda l: l.unsqueeze(0).repeat(
        (capacity,) + (1,) * l.dim()), row_tree)


@dataclasses.dataclass
class SlotStepRecord:
    """One training round of the slot runtime."""

    step: int
    time: float
    num_alive: int
    participating: int
    loss: float
    swapped: bool
    cache_hit: bool
    joined: Tuple[int, ...]
    left: Tuple[int, ...]


class SlotTrainLoop:
    """Drive a mask-aware local step under churn with static shapes.

    ``make_params(node_id)`` builds one client's (unstacked) parameter
    tree, on the device the loop should run on; ``make_batch(node_ids,
    step)`` a stacked batch (a dict of tensors) for the given alive set,
    keyed by node identity so survivors keep their data across remaps.
    ``local_step`` is ``(params, opt_state, batch, mask) -> (params,
    opt_state, metrics)``, where ``params`` is the capacity-stacked tree
    of views into the flat buffer and ``mask`` the
    (capacity,) numpy alive mask.

    ``periods`` (optional, node id → MEP period) enables multirate
    participation: the mixing mask at round t is ``alive & (t % k_u ==
    0)``; the local-step mask stays pure aliveness.

    The optimizer state starts as ``optimizer.init`` of the first live
    client's tree in every slot (the port's optimizers initialise from
    shapes alone), and a joiner's row is re-initialised.
    """

    def __init__(self, controller: OverlayController, *,
                 local_step: Callable,
                 make_params: Callable[[int], object],
                 optimizer,
                 make_batch: Callable[[Sequence[int], int], Dict[str, torch.Tensor]],
                 periods: Optional[Dict[int, float]] = None,
                 ledger=None):
        if controller.slots is None:
            raise ValueError(
                "SlotTrainLoop needs a capacity-mode controller "
                "(OverlayController(..., capacity=C))")
        if not controller.flat_io:
            raise ValueError(
                "SlotTrainLoop keeps the population resident flat: it needs "
                "OverlayController(..., fuse=\"flat\", flat_io=True)")
        self.controller = controller
        self.capacity = C = controller.capacity
        self.local_step = local_step
        self.optimizer = optimizer
        self.make_params = make_params
        self.make_batch = make_batch
        self.periods = periods
        self._ledger = ledger
        self._step = 0
        self._bytes_cache: Dict[tuple, tuple] = {}
        self.records: List[SlotStepRecord] = []

        live = [(s, controller.slots.node_at(s)) for s in range(C)
                if controller.slots.node_at(s) is not None]
        if not live:
            raise ValueError("controller has no live nodes")
        first = make_params(live[0][1])
        # the stacked layout, read from shapes alone (expand is a view)
        shape_tree = tree_map(lambda l: l.unsqueeze(0).expand(
            (C,) + tuple(l.shape)), first)
        self._spec = FlatSpec.for_tree(shape_tree)
        self._row_spec = FlatSpec.for_tree(
            tree_map(lambda l: l.unsqueeze(0), first))
        dev = tree_flatten(first)[0][0].device
        # resident state, allocated once; dead slots hold zeros
        self.params = torch.zeros((C, self._spec.size),
                                  dtype=self._spec.dtype, device=dev)
        self._spare = torch.empty_like(self.params)
        self.opt_state = _stacked(optimizer.init(first), C)
        for slot, node in live:
            self._write_row(slot, first if slot == live[0][0]
                            else make_params(node))
        del first

    # ---- state surgery ---------------------------------------------------
    def _write_row(self, slot: int, row) -> None:
        """Write one client's (unstacked) tree into ``slot``."""
        self._row_spec.ravel(tree_map(lambda l: l.unsqueeze(0), row),
                             out=self.params[slot:slot + 1])

    def client_params(self, node_id: int):
        """The (unstacked) current model of one live client, as views."""
        slot = self.controller.slots.slot_of[node_id]
        return self._row_spec.unravel_row(self.params[slot])

    def _apply_plan(self, plan: RemapPlan) -> Tuple[Tuple[int, ...],
                                                    Tuple[int, ...]]:
        """Membership change as in-place row writes: joiners get a donor
        copy (Fig. 18 catch-up from the highest-confidence surviving
        neighbor) or a fresh init when every neighbor is itself a joiner,
        and a fresh optimizer row; leavers' rows just go dead."""
        ctl = self.controller
        joiners = tuple(u for u, _ in plan.joiners)
        survivors = tuple(u for u, _ in plan.survivors)
        donors = (joiner_donors(ctl.alive_schedule, ctl.alive, joiners,
                                survivors) if joiners else {})
        for node, slot in plan.joiners:
            donor = donors.get(node)
            if donor is None:
                self._write_row(slot, self.make_params(node))
            else:
                self.params[slot].copy_(self.params[ctl.slots.slot_of[donor]])
            for d, s in zip(tree_flatten(self.opt_state)[0], tree_flatten(
                    self.optimizer.init(self.client_params(node)))[0]):
                d[slot].copy_(s)
        return joiners, tuple(u for u, _ in plan.leavers)

    # ---- per-round masks and batches -------------------------------------
    def _mix_mask(self, alive: Tuple[int, ...],
                  alive_mask: np.ndarray, step: int) -> np.ndarray:
        if self.periods is None:
            return alive_mask
        part = multirate_participation(
            [self.periods.get(u, 1.0) for u in alive], step)
        mask = alive_mask.copy()
        slot_of = self.controller.slots.slot_of
        for i, u in enumerate(alive):
            mask[slot_of[u]] *= part[i]
        return mask

    def _edge_mask(self) -> Tuple[Optional[np.ndarray], int]:
        """The round's (capacity, 2L) unreachable-edge mask from the
        simulator's ``data_faults()``, or (None, 0) without one."""
        sim = self.controller.sim
        if not hasattr(sim, "data_faults"):
            return None, 0
        ctl = self.controller
        slot_nodes = [ctl.slots.node_at(s) for s in range(self.capacity)]
        em = edge_mask_for(ctl.schedule, slot_nodes, sim.data_faults())
        return em, int((em == 0.0).sum())

    def _capacity_batch(self, alive: Tuple[int, ...], step: int):
        """Scatter the alive-set batch onto capacity rows (dead slots
        replay row 0's data; the step ignores them)."""
        batch = self.make_batch(alive, step)
        pos = {u: i for i, u in enumerate(alive)}
        idx = np.zeros((self.capacity,), dtype=np.int64)
        for slot in range(self.capacity):
            node = self.controller.slots.node_at(slot)
            if node is not None:
                idx[slot] = pos[node]
        return {k: v[torch.as_tensor(idx, device=v.device)]
                for k, v in batch.items()}

    # ---- telemetry -------------------------------------------------------
    def _record_round(self, ledger, step: int, report, participating: int,
                      loss: float, joined, left, degraded_edges: int) -> None:
        """One :class:`repro_torch.obs.rounds.RoundRecord`: the closed-form
        wire bytes for this round's participation and the control-plane
        latencies (repair = the schedule rebuild churn forced, commit =
        the staged-swap flip)."""
        from ..dist.sync import sync_bytes_per_client
        ctl = self.controller
        key = (ctl.strategy, ctl.schedule.num_spaces,
               max(int(participating), 1))
        wire = self._bytes_cache.get(key)
        if wire is None:
            wire = self._bytes_cache[key] = sync_bytes_per_client(
                ctl.strategy, 4 * self._spec.size, self.capacity,
                num_spaces=key[1], active_clients=key[2])
        ledger.record(
            round=step, time=report.time, loop="slot",
            num_alive=len(report.alive), participating=int(participating),
            loss=loss, wire_bytes_per_client=wire,
            payload_bytes_per_client=wire,
            swapped=report.swapped, rebuilt=report.rebuilt,
            cache_hit=report.cache_hit, joined=joined, left=left,
            repair_ms=report.rebuild_ms, commit_ms=ctl.last_commit_ms,
            degraded_edges=degraded_edges)

    # ---- the loop --------------------------------------------------------
    def run(self, num_steps: int,
            trace: Optional[ChurnTrace] = None) -> List[SlotStepRecord]:
        """``num_steps`` training rounds, one control interval of
        ``ROUND_TIME`` each.  An explicit ``ledger=`` on the loop is
        installed as the process ledger for the run."""
        with round_ledger(self._ledger) if self._ledger is not None \
                else contextlib.nullcontext():
            for _ in range(num_steps):
                self._round(trace)
        return self.records

    def _round(self, trace: Optional[ChurnTrace]) -> None:
        ctl = self.controller
        step = self._step
        report = ctl.step(ROUND_TIME, trace=trace)
        plan = ctl.commit()          # the swap lands at the round boundary
        joined, left = ((), ())
        if plan is not None and plan.changed:
            joined, left = self._apply_plan(plan)
        alive = ctl.alive
        alive_mask = ctl.alive_mask()
        mix_mask = self._mix_mask(alive, alive_mask, step)
        batch = self._capacity_batch(alive, step)
        em, degraded = self._edge_mask()
        params, opt_state, metrics = self.local_step(
            self._spec.unravel(self.params), self.opt_state, batch, alive_mask)
        self._spec.ravel(params, out=self.params)
        _store(self.opt_state, opt_state)
        # the hot-swap seam: the controller's mask-aware mixer; slow or
        # dead slots pass through untouched
        mkw = {} if em is None else {"edge_mask": em}
        mixed = ctl.mixer(self.params, mix_mask, out=self._spare, **mkw)
        self.params, self._spare = mixed, self.params
        part = int(mix_mask.sum())
        loss = float(metrics["loss"])
        self.records.append(SlotStepRecord(
            step=step, time=report.time, num_alive=len(alive),
            participating=part, loss=loss,
            swapped=report.swapped, cache_hit=report.cache_hit,
            joined=joined, left=left))
        bus = get_telemetry()
        if bus.enabled:
            bus.count("slot.steps")
            bus.gauge("slot.num_alive", len(alive))
            bus.gauge("slot.participating", part)
        ledger = get_round_ledger()
        if ledger is not None:
            self._record_round(ledger, step, report, part, loss, joined,
                               left, degraded)
        self._step += 1
