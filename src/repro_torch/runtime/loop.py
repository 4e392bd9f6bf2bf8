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
(:class:`repro_torch.runtime.resident.Resident`, which the front door
shares), and the local step sees a
tree of views into it; the mixer writes the round into the second
buffer and the two swap roles every round.  The reference's other mode,
a resident parameter tree, waits for the slice whose path needs it.

A controller with a wire codec compresses each round
(:mod:`repro_torch.wire.codec`).  The loop then also holds the codec's
wire buffers (its ``workspace``), allocated once, and for an
error-feedback codec the (capacity, N) f32 residual, allocated once and
updated in place: joiner and leaver rows are zeroed as a plan lands
(:func:`repro_torch.runtime.slots.plan_reset_slots`), masked-out rows
keep theirs.  The round forms ``buf + residual`` in the mixer's output
buffer, which is free until the round writes it.

``save`` / ``restore`` checkpoint the training state in the reference's
format (:mod:`repro_torch.ckpt`): its leaf list, in the reference's
order, with the step and the slot occupancy, so a checkpoint of either
package's loop restores in the other.  ``restore`` copies into the
resident buffers in place.

A simulator that offers ``data_faults()`` (a
:class:`repro_torch.faults.ChaosEngine`) turns on **degraded rounds**:
every round the active link outages, stragglers and partition are
lowered to the (capacity, 2L) unreachable-edge mask that the mixer takes
as a runtime input, and ``health`` (a
:class:`repro_torch.faults.HealthTracker`) folds its suspect and evicted
peers into the same mask.  The round ledger then carries each round's
``faults_injected`` (the chaos engine's injections since the previous
round) and ``degraded_edges``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ckpt.checkpoint import load as ckpt_load, save as ckpt_save, state_leaves
from ..core.mixing import multirate_participation
from ..dist.flat import tree_flatten
from ..faults.plan import DataFaults, edge_mask_for
from ..obs.events import get_telemetry
from ..obs.rounds import get_round_ledger, round_ledger
from ..overlay.controller import OverlayController
from ..overlay.events import ChurnTrace
from ..overlay.runtime import joiner_donors
from .resident import Resident
from .slots import RemapPlan, plan_reset_slots

#: Simulated seconds of NDMP time one training round advances.
ROUND_TIME = 1.0


def _store(dst, src) -> None:
    """Copy a tree into a resident tree of the same structure, leaf by
    leaf, skipping leaves that already are the destination."""
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        if s.data_ptr() != d.data_ptr():
            d.copy_(s)


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
                 ledger=None, health=None):
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
        self.health = health
        # degraded rounds: a chaos engine (anything with data_faults())
        # as the controller's simulator, and/or a health tracker
        self._chaos_engine = (controller.sim
                              if hasattr(controller.sim, "data_faults") else None)
        self._faults_on = self._chaos_engine is not None or health is not None
        self._last_fault_count = 0
        self._step = 0
        self._bytes_cache: Dict[tuple, tuple] = {}
        self.records: List[SlotStepRecord] = []

        live = [(s, controller.slots.node_at(s)) for s in range(C)
                if controller.slots.node_at(s) is not None]
        if not live:
            raise ValueError("controller has no live nodes")
        first = make_params(live[0][1])
        self.codec = controller.codec
        self.ef = self.codec is not None and self.codec.error_feedback
        # resident state, allocated once; dead slots hold zeros
        self.state = Resident.allocate(first, C, optimizer, spare=True, codec=self.codec,
                                       error_feedback=self.ef)
        for slot, node in live:
            self.state.write_row(slot, first if slot == live[0][0] else make_params(node))
        del first

    # the resident state's buffers, by the names the loop's callers read
    params = property(lambda self: self.state.params)
    opt_state = property(lambda self: self.state.opt_state)
    residual = property(lambda self: self.state.residual)
    workspace = property(lambda self: self.state.workspace)
    _spare = property(lambda self: self.state.spare)
    _spec = property(lambda self: self.state.spec)

    # ---- state surgery ---------------------------------------------------
    def client_params(self, node_id: int):
        """The (unstacked) current model of one live client, as views."""
        return self.state.row(self.controller.slots.slot_of[node_id])

    def _apply_plan(self, plan: RemapPlan) -> Tuple[Tuple[int, ...],
                                                    Tuple[int, ...]]:
        """Membership change as in-place row writes: joiners get a donor
        copy (Fig. 18 catch-up from the highest-confidence surviving
        neighbor) or a fresh init when every neighbor is itself a joiner,
        and a fresh optimizer row; leavers' rows just go dead.  The
        error-feedback residual rows of joiner and leaver slots are
        zeroed."""
        ctl = self.controller
        joiners = tuple(u for u, _ in plan.joiners)
        survivors = tuple(u for u, _ in plan.survivors)
        donors = (joiner_donors(ctl.alive_schedule, ctl.alive, joiners,
                                survivors) if joiners else {})
        for node, slot in plan.joiners:
            donor = donors.get(node)
            if donor is None:
                self.state.write_row(slot, self.make_params(node))
            else:
                self.params[slot].copy_(self.params[ctl.slots.slot_of[donor]])
            for d, s in zip(tree_flatten(self.opt_state)[0], tree_flatten(
                    self.optimizer.init(self.client_params(node)))[0]):
                d[slot].copy_(s)
        if self.ef:
            for slot in plan_reset_slots(plan):
                self.residual[slot].zero_()
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

    def _edge_mask(self, now: float) -> Tuple[Optional[np.ndarray], int]:
        """The round's (capacity, 2L) unreachable-edge mask, or (None, 0)
        without fault plumbing: the chaos engine's data-plane faults and
        the health tracker's unhealthy peers (polled at ``now``), as one
        host-built numpy mask."""
        if not self._faults_on:
            return None, 0
        df = (self._chaos_engine.data_faults()
              if self._chaos_engine is not None else DataFaults())
        if self.health is not None:
            self.health.poll(now)
            bad = self.health.unhealthy()
            if bad:
                df = DataFaults(down_pairs=df.down_pairs,
                                slow_nodes=df.slow_nodes | bad, groups=df.groups)
        ctl = self.controller
        slot_nodes = [ctl.slots.node_at(s) for s in range(self.capacity)]
        em = edge_mask_for(ctl.schedule, slot_nodes, df)
        return em, int((em == 0.0).sum())

    def _faults_injected(self) -> int:
        """The chaos engine's injections since the previous round."""
        if self._chaos_engine is None or not hasattr(self._chaos_engine, "counts"):
            return 0
        total = sum(self._chaos_engine.counts.values())
        delta, self._last_fault_count = total - self._last_fault_count, total
        return delta

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

    # ---- crash/resume ----------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """The full training state, as the loop's own tensors: the
        (capacity, N) flat population, the capacity-stacked optimizer
        state and, for an error-feedback codec, the residual.  Everything
        else (schedules, mixers, slot map) is a function of the
        controller's simulator, which a resume rebuilds by replaying the
        control plane."""
        state = {"params": self.params, "opt_state": self.opt_state}
        if self.ef:
            state["residual"] = self.residual
        return state

    def _occupancy(self) -> List[int]:
        slots = self.controller.slots
        return [-1 if slots.node_at(s) is None else int(slots.node_at(s))
                for s in range(self.capacity)]

    def save(self, path: str) -> None:
        """Checkpoint the training state, the step counter and the slot
        occupancy to ``path`` (``.npz`` and ``.json``), as the reference's
        loop does: the state as its leaf list in the reference's order
        (:func:`repro_torch.ckpt.checkpoint.state_leaves`), so a resume
        must build the loop the same way (capacity, codec, optimizer)."""
        ckpt_save(path, {"leaves": state_leaves(self.state_dict())},
                  metadata={"step": int(self._step), "slots": self._occupancy(),
                            "ef": bool(self.ef), "flat_io": True})

    def restore(self, path: str) -> dict:
        """Exact resume from :meth:`save` (either package's): the
        population, optimizer state and residual bit for bit, copied into
        the loop's resident buffers in place, and the step counter.  The
        caller replays the control plane to the checkpoint's step first;
        a different wire configuration or slot occupancy raises
        ``ValueError``.  Returns the checkpoint's metadata."""
        tree, meta = ckpt_load(path)
        if bool(meta.get("ef")) != self.ef or not meta.get("flat_io"):
            raise ValueError(
                "checkpoint was written by a loop with a different "
                f"wire configuration (ef={meta.get('ef')}, "
                f"flat_io={meta.get('flat_io')})")
        occupancy = self._occupancy()
        if list(meta.get("slots", ())) != occupancy:
            raise ValueError(
                "slot occupancy mismatch: replay the control plane to "
                f"the checkpoint step first (ckpt {meta.get('slots')} "
                f"vs live {occupancy})")
        want, leaves = state_leaves(self.state_dict()), tree["leaves"]
        if len(leaves) != len(want):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                             f"this loop expects {len(want)}")
        for have, exp in zip(leaves, want):
            if tuple(have.shape) != tuple(exp.shape) or have.dtype != exp.dtype:
                raise ValueError(
                    f"leaf mismatch: checkpoint {tuple(have.shape)}/{have.dtype} "
                    f"vs live {tuple(exp.shape)}/{exp.dtype}")
        for have, exp in zip(leaves, want):
            exp.copy_(have)
        self._step = int(meta["step"])
        self._last_fault_count = (sum(self._chaos_engine.counts.values())
                                  if hasattr(self._chaos_engine, "counts") else 0)
        return meta

    # ---- telemetry -------------------------------------------------------
    def _record_round(self, ledger, step: int, report, participating: int,
                      loss: float, joined, left, faults_injected: int,
                      degraded_edges: int) -> None:
        """One :class:`repro_torch.obs.rounds.RoundRecord`: the closed-form
        wire bytes for this round's participation (the codec's wire
        image) beside the payload bytes (the uncompressed row, as the
        reference's ledger has it), and the control-plane latencies
        (repair = the schedule rebuild churn forced, commit = the
        staged-swap flip)."""
        from ..dist.sync import round_bytes_per_client
        ctl = self.controller
        wire, payload = round_bytes_per_client(
            self._bytes_cache, ctl.strategy, 4 * self._spec.size, self.capacity,
            codec=ctl.codec, num_spaces=ctl.schedule.num_spaces,
            active_clients=max(int(participating), 1))
        ledger.record(
            round=step, time=report.time, loop="slot",
            num_alive=len(report.alive), participating=int(participating),
            loss=loss, wire_bytes_per_client=wire,
            payload_bytes_per_client=payload,
            swapped=report.swapped, rebuilt=report.rebuilt,
            cache_hit=report.cache_hit, joined=joined, left=left,
            repair_ms=report.rebuild_ms, commit_ms=ctl.last_commit_ms,
            faults_injected=faults_injected, degraded_edges=degraded_edges)

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
        em, degraded = self._edge_mask(report.time)
        params, opt_state, metrics = self.local_step(
            self._spec.unravel(self.params), self.opt_state, batch, alive_mask)
        self._spec.ravel(params, out=self.params)
        _store(self.opt_state, opt_state)
        # the hot-swap seam: the controller's mask-aware mixer; slow or
        # dead slots pass through untouched
        mkw = {} if em is None else {"edge_mask": em}
        if self.codec is not None:
            mkw["workspace"] = self.workspace
        if self.ef:
            ctl.mixer(self.params, mix_mask, self.residual, out=self._spare, **mkw)
        else:
            ctl.mixer(self.params, mix_mask, out=self._spare, **mkw)
        self.state.swap()
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
            self._record_round(ledger, step, report, part, loss, joined, left,
                               self._faults_injected(), degraded)
        self._step += 1
