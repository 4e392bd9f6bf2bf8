"""Cohort streaming: a fixed-capacity device pool serving an unbounded overlay.

The port of ``repro/scale/cohort.py``.  The device holds C slots but the
overlay holds n ≫ C nodes.  Each round a :class:`CohortSampler` draws a
K ≤ C cohort of alive nodes; the :class:`~repro_torch.runtime.slots.SlotMap`
reconciles it as an identity-preserving
:class:`~repro_torch.runtime.slots.RemapPlan` (stream-out parks a node's
model on the host, stream-in restores it — a node that returns rounds
later continues from its own parameters); the cohort's induced FedLay
schedule comes from :func:`repro_torch.core.mixing.schedule_from_addresses`
over the cohort addresses, capacity-padded so unsampled slots self-loop;
and the mixing round is one :func:`repro_torch.kernels.gather_mix.gather_mix`
call whose (C, 2L+1) source and weight tables are device tensors — cohort
composition is data, so every round of every cohort runs the same kernel
on the same buffers.

Zero reallocation takes the place of the reference's zero retraces: the
(C, dim) population buffer and the round's output buffer are allocated
once and swap roles every round (their ``data_ptr`` never changes), and
so are the round's tables and mask.  Stream-in is one in-place
``index_copy_`` of the incoming rows into the resident buffer.  On the
card the capacity is bounded by ``gather_mix``'s ``GATHER_MAX_C``
(1,816): a larger capacity raises ``ValueError`` when the loop is built.

The weighting contract (see the package docstring): the padded cohort
schedule's dense image :func:`cohort_mixing_matrix` is row-stochastic,
restricted to the cohort, and with the full population sampled it *is*
the dense full-participation mixing matrix.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.coords import NodeAddress, coordinates_batch
from ..core.mep import ClientProfile
from ..core.mixing import (PermuteSchedule, pad_schedule,
                           schedule_from_addresses, schedule_mixing_matrix)
from ..obs.events import get_telemetry
from ..obs.rounds import get_round_ledger
from ..overlay.runtime import joiner_donors
from ..runtime.slots import RemapPlan, SlotMap


# --------------------------------------------------------------------------
# Schedule → runtime gather tables
# --------------------------------------------------------------------------

def schedule_tables(sched: PermuteSchedule) -> Tuple[np.ndarray, np.ndarray]:
    """A schedule as ``gather_mix`` tables: (C, 2L+1) ``srcs`` int32 and
    ``weights`` float32, column 0 the self edge.  Row-stochastic by
    schedule construction; dead slots of a padded schedule come out as
    pure self-loops.  These are the *runtime inputs* of the cohort
    mixer — same shapes every round, whatever the cohort."""
    C, S = sched.num_clients, sched.num_slots
    srcs = np.empty((C, S + 1), dtype=np.int32)
    weights = np.empty((C, S + 1), dtype=np.float32)
    srcs[:, 0] = np.arange(C)
    weights[:, 0] = sched.self_weight
    for k in range(S):
        srcs[:, k + 1] = sched.perms[k]
        weights[:, k + 1] = sched.weights[:, k]
    return srcs, weights


def cohort_addresses(cohort: Sequence[int], num_spaces: int,
                     salt: str = "") -> List[NodeAddress]:
    """Addresses for a cohort — coordinates are pure functions of the
    node id (the paper's public hash), so no engine round-trip is
    needed; the batch hasher keeps this cheap for large cohorts."""
    ids = list(cohort)
    coords = coordinates_batch(ids, num_spaces, salt)
    return [NodeAddress(node_id=int(u), coords=tuple(coords[i]))
            for i, u in enumerate(ids)]


def cohort_schedule(cohort: Sequence[int], num_spaces: int,
                    slot_of: Dict[int, int], capacity: int, *,
                    salt: str = "",
                    profiles: Optional[Dict[int, ClientProfile]] = None,
                    alpha_d: float = 0.5, alpha_c: float = 0.5,
                    confidence_weighted: bool = True
                    ) -> Tuple[PermuteSchedule, PermuteSchedule]:
    """(cohort-level, capacity-padded) schedules for one round.

    The cohort-level schedule is the induced FedLay over the cohort —
    every member's ring pred/succ *within the cohort* — built by the
    same :func:`schedule_from_addresses` the live controller uses, so
    cohort weighting inherits MEP confidence weighting and duplicate-
    adjacency dedup unchanged.  The padded schedule embeds it into the
    capacity slots per ``slot_of`` (unsampled slots self-loop)."""
    addrs = cohort_addresses(cohort, num_spaces, salt)
    sched = schedule_from_addresses(
        addrs, profiles=profiles, alpha_d=alpha_d, alpha_c=alpha_c,
        confidence_weighted=confidence_weighted)
    padded = pad_schedule(sched, [slot_of[int(u)] for u in cohort], capacity)
    return sched, padded


def cohort_mixing_matrix(cohort: Sequence[int], num_spaces: int,
                         slot_of: Dict[int, int], capacity: int,
                         **kwargs) -> np.ndarray:
    """The dense (capacity, capacity) oracle of one cohort round —
    row-stochastic, identity on unsampled slots.  Test currency: the
    device path must reproduce ``M @ buf`` within float32 tolerance,
    and with ``cohort == alive`` this equals the full-participation
    mixing matrix."""
    _, padded = cohort_schedule(cohort, num_spaces, slot_of, capacity,
                                **kwargs)
    return schedule_mixing_matrix(padded)


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------

class CohortSampler:
    """Draw the round's K-node cohort from an engine's alive set.

    Deterministic per ``(seed, round_index)`` — two runs of the same
    trace sample identical cohorts.  ``weighted=True`` biases the draw
    by per-node MEP confidence when the engine exposes a ``confidence``
    row array (:class:`repro_torch.scale.ndmp_vec.VectorSimulator`);
    engines without one fall back to uniform.  When fewer than K nodes
    are alive the whole population is the cohort."""

    def __init__(self, sim, cohort_size: int, *, seed: int = 0,
                 weighted: bool = False):
        if cohort_size < 1:
            raise ValueError("cohort_size must be >= 1")
        self.sim = sim
        self.cohort_size = cohort_size
        self.seed = seed
        self.weighted = weighted

    def _confidences(self, alive: List[int]) -> Optional[np.ndarray]:
        conf = getattr(self.sim, "confidence", None)
        row_of = getattr(self.sim, "_row_of", None)
        if conf is None or row_of is None:
            return None
        return np.asarray([conf[row_of[u]] for u in alive], dtype=np.float64)

    def sample(self, round_index: int) -> Tuple[int, ...]:
        alive = self.sim.alive_ids()
        if len(alive) <= self.cohort_size:
            return tuple(alive)
        rng = np.random.default_rng([self.seed, round_index])
        p = None
        if self.weighted:
            c = self._confidences(alive)
            if c is not None and c.sum() > 0:
                p = c / c.sum()
        picked = rng.choice(len(alive), size=self.cohort_size,
                            replace=False, p=p)
        return tuple(sorted(alive[i] for i in picked))


# --------------------------------------------------------------------------
# The streaming loop
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CohortRoundRecord:
    """One cohort round: membership motion + data-plane accounting (the
    reference's record without its retrace count)."""

    round: int
    time: float
    cohort_size: int
    streamed_in: int
    streamed_out: int
    restored: int         # stream-ins that resumed a parked model
    donor_seeded: int     # cold slots seeded by Fig-18 donor catch-up
    fresh: int            # cold slots with no surviving donor
    remap_ms: float       # host time for park/restore/schedule rebuild
    evicted: int = 0      # LRU park evictions this round


class CohortStreamLoop:
    """Train a resident (capacity, dim) f32 population buffer against an
    arbitrarily large overlay, one sampled cohort per round, on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``).

    ``make_params(node_id) -> (dim,)`` initializes one node's flat model
    (numpy) the first time it is sampled.  ``local_fn`` (optional) is a
    per-round local update ``(buf, mask) -> buf`` applied before mixing
    (mask = 1 on occupied slots, a (capacity,) f32 tensor on the device).

    Stream-out **parks** a node's row on the host and stream-in restores
    it — node identity is preserved across arbitrarily long absences.
    By default the park is unbounded (it grows with the number of
    *distinct* nodes ever sampled); ``max_parked`` bounds it with LRU
    eviction — least-recently-parked rows are dropped first, and the
    optional snapshot/restore policy decides what eviction means:

    * ``snapshot_fn(node_id, row)`` is called with every evicted row —
      e.g. spill to disk or object storage.  Without one the row is
      simply discarded (the node re-enters cold, via donor catch-up).
    * ``restore_fn(node_id) -> row | None`` is consulted on stream-in
      when the node is not in the host park — the read side of the
      snapshot policy.  A non-None row counts as ``restored`` exactly
      like a park hit.

    A node sampled for the first time is seeded by Fig-18 donor
    catch-up: the highest-confidence cohort neighbor that is itself a
    survivor/restored member donates its current model; all-cold
    neighborhoods fall back to ``make_params``.
    """

    def __init__(self, sim, *, capacity: int, cohort_size: int,
                 make_params: Callable[[int], np.ndarray],
                 sampler: Optional[CohortSampler] = None,
                 local_fn: Optional[Callable] = None,
                 profiles_fn: Optional[Callable[
                     [Tuple[int, ...]], Dict[int, ClientProfile]]] = None,
                 round_time: float = 1.0, seed: int = 0,
                 max_parked: Optional[int] = None,
                 snapshot_fn: Optional[
                     Callable[[int, np.ndarray], None]] = None,
                 restore_fn: Optional[
                     Callable[[int], Optional[np.ndarray]]] = None,
                 device="cuda"):
        from ..kernels.gather_mix import GATHER_MAX_C

        if cohort_size > capacity:
            raise ValueError(f"cohort_size {cohort_size} exceeds "
                             f"capacity {capacity}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and capacity > GATHER_MAX_C:
            raise ValueError(
                f"the CUDA gather_mix mixes at most {GATHER_MAX_C} slots, so the "
                f"cohort capacity on the card is <= {GATHER_MAX_C}; got {capacity}")
        self.sim = sim
        self.capacity = capacity
        self.slots = SlotMap(capacity)
        self.sampler = sampler or CohortSampler(sim, cohort_size, seed=seed)
        self.make_params = make_params
        self.local_fn = local_fn
        self.profiles_fn = profiles_fn
        self.round_time = round_time
        self.salt = getattr(sim, "salt", "")
        self.num_spaces = sim.num_spaces
        if max_parked is not None and max_parked < 1:
            raise ValueError("max_parked must be >= 1 (or None)")
        self.park: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.max_parked = max_parked
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.evictions = 0
        self.records: List[CohortRoundRecord] = []
        self._round = 0

        probe = self.sim.alive_ids()
        if not probe:
            raise ValueError("engine has no live nodes")
        self.dim = dim = int(np.asarray(make_params(probe[0])).shape[0])
        # the resident state, allocated once: the population, the round's
        # output (the two swap roles every round), its tables and mask
        K1 = 2 * self.num_spaces + 1
        self.buf = torch.zeros((capacity, dim), dtype=torch.float32, device=self.device)
        self.spare = torch.empty_like(self.buf)
        self.srcs = torch.zeros((capacity, K1), dtype=torch.int32, device=self.device)
        self.weights = torch.zeros((capacity, K1), dtype=torch.float32,
                                   device=self.device)
        self.mask = torch.zeros((capacity,), dtype=torch.float32, device=self.device)

    # ---- state access ----------------------------------------------------
    def client_params(self, node_id: int) -> np.ndarray:
        """A node's current model — live slot row if resident, parked
        copy otherwise; evicted nodes fall back to the snapshot policy's
        ``restore_fn`` (identity preservation, testable)."""
        slot = self.slots.slot_of.get(node_id)
        if slot is not None:
            return self.buf[slot].cpu().numpy()
        row = self.park.get(node_id)
        if row is None and self.restore_fn is not None:
            row = self.restore_fn(node_id)
        if row is None:
            raise KeyError(f"node {node_id} is neither resident, parked, "
                           f"nor restorable")
        return row

    def _park_row(self, node_id: int, row: np.ndarray) -> int:
        """Park one row, LRU-evicting past ``max_parked`` (evicted rows
        go through ``snapshot_fn`` if set).  Returns evictions."""
        self.park[node_id] = row
        self.park.move_to_end(node_id)
        evicted = 0
        while (self.max_parked is not None
               and len(self.park) > self.max_parked):
            victim, vrow = self.park.popitem(last=False)
            if self.snapshot_fn is not None:
                self.snapshot_fn(victim, vrow)
            evicted += 1
        self.evictions += evicted
        return evicted

    def _unpark_row(self, node_id: int) -> Optional[np.ndarray]:
        """Take a row out of the park, falling back to ``restore_fn``
        for snapshot-evicted nodes.  None = genuinely cold."""
        row = self.park.pop(node_id, None)
        if row is None and self.restore_fn is not None:
            row = self.restore_fn(node_id)
        return row

    def _warm(self, node_id: int) -> bool:
        return (node_id in self.park
                or (self.restore_fn is not None
                    and self.restore_fn(node_id) is not None))

    def _slot_index(self, slots: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, dtype=np.int64), device=self.device)

    # ---- one round -------------------------------------------------------
    def _reconcile(self, cohort: Tuple[int, ...],
                   sched: PermuteSchedule,
                   plan: RemapPlan) -> Tuple[int, int, int, int]:
        """Stream-out to the park, stream-in from park / snapshot /
        donor / fresh.  Returns (restored, donor_seeded, fresh,
        evicted) counts."""
        evicted = 0
        if plan.leavers:
            # one gather and one copy to the host for every leaver's row
            out = self.buf.index_select(0, self._slot_index(
                [s for _, s in plan.leavers])).cpu().numpy()
            for (u, _), row in zip(plan.leavers, out):
                evicted += self._park_row(u, row)
        self.slots.apply(plan)
        joiners = tuple(u for u, _ in plan.joiners)
        if not joiners:
            return 0, 0, 0, evicted
        survivors = tuple(u for u, _ in plan.survivors)
        cold = [u for u in joiners if not self._warm(u)]
        # parked members count as warm donors: they resume their own
        # model, so their row is as trustworthy as a survivor's
        donors = joiner_donors(sched, cohort, cold,
                               tuple(set(survivors)
                                     | (set(joiners) - set(cold)))) \
            if cold else {}
        slot_of = self.slots.slot_of
        restored = donor_seeded = fresh = 0
        host_rows, host_at, donor_slots, donor_at = [], [], [], []
        for i, (u, _) in enumerate(plan.joiners):
            row = self._unpark_row(u)
            if row is not None:
                host_rows.append(row)
                host_at.append(i)
                restored += 1
            else:
                donor = donors.get(u)
                if donor is not None and donor in slot_of:
                    donor_slots.append(slot_of[donor])
                    donor_at.append(i)
                    donor_seeded += 1
                else:
                    host_rows.append(np.asarray(self.make_params(u), dtype=np.float32))
                    host_at.append(i)
                    fresh += 1
        # the incoming rows, staged before any is written (a donor row is
        # read as the buffer holds it now), then one in-place index_copy_
        rows = torch.empty((len(plan.joiners), self.dim), dtype=self.buf.dtype,
                           device=self.device)
        if host_rows:
            rows[self._slot_index(host_at)] = torch.from_numpy(
                np.stack(host_rows).astype(np.float32, copy=False)).to(self.device)
        if donor_slots:
            rows[self._slot_index(donor_at)] = self.buf.index_select(
                0, self._slot_index(donor_slots))
        self.buf.index_copy_(0, self._slot_index([s for _, s in plan.joiners]), rows)
        return restored, donor_seeded, fresh, evicted

    def _mix(self) -> None:
        """The round on the device: the local update, then one
        ``gather_mix`` into the spare buffer, which becomes the
        population."""
        from ..kernels.gather_mix import gather_mix
        src = self.buf if self.local_fn is None else self.local_fn(self.buf, self.mask)
        gather_mix(src, self.srcs, self.weights, out=self.spare)
        self.buf, self.spare = self.spare, self.buf

    def run(self, num_rounds: int) -> List[CohortRoundRecord]:
        for _ in range(num_rounds):
            r = self._round
            self.sim.advance(self.round_time)
            cohort = self.sampler.sample(r)
            t0 = _time.perf_counter()
            plan = self.slots.plan(cohort)
            profiles = (self.profiles_fn(cohort)
                        if self.profiles_fn is not None else None)
            sched, padded = cohort_schedule(
                cohort, self.num_spaces, plan.slot_of, self.capacity,
                salt=self.salt, profiles=profiles)
            restored, donor_seeded, fresh, evicted = self._reconcile(
                cohort, sched, plan)
            srcs, weights = schedule_tables(padded)
            mask = np.zeros((self.capacity,), dtype=np.float32)
            mask[[plan.slot_of[u] for u in cohort]] = 1.0
            self.srcs.copy_(torch.from_numpy(srcs))
            self.weights.copy_(torch.from_numpy(weights))
            self.mask.copy_(torch.from_numpy(mask))
            remap_ms = (_time.perf_counter() - t0) * 1e3
            self._mix()
            self.records.append(CohortRoundRecord(
                round=r, time=self.sim.now, cohort_size=len(cohort),
                streamed_in=len(plan.joiners),
                streamed_out=len(plan.leavers),
                restored=restored, donor_seeded=donor_seeded, fresh=fresh,
                remap_ms=remap_ms, evicted=evicted))
            bus = get_telemetry()
            if bus.enabled:
                bus.count("cohort.rounds")
                bus.count("cohort.streamed_in", len(plan.joiners))
                bus.count("cohort.streamed_out", len(plan.leavers))
                if evicted:
                    bus.count("cohort.park_evictions", evicted)
                bus.gauge("cohort.parked", len(self.park))
                bus.observe("cohort.remap_ms", remap_ms)
            ledger = get_round_ledger()
            if ledger is not None:
                from ..dist.sync import sync_bytes_per_client
                wire = sync_bytes_per_client(
                    "fedlay", 4 * self.dim, self.capacity,
                    num_spaces=self.num_spaces,
                    active_clients=len(cohort))
                ledger.record(
                    round=r, time=self.sim.now, loop="cohort",
                    num_alive=len(cohort), participating=len(cohort),
                    wire_bytes_per_client=wire,
                    payload_bytes_per_client=wire,
                    swapped=bool(plan.changed), rebuilt=True,
                    joined=tuple(u for u, _ in plan.joiners),
                    left=tuple(u for u, _ in plan.leavers),
                    repair_ms=remap_ms,
                    restored=restored, donor_seeded=donor_seeded,
                    fresh=fresh, evicted=evicted)
            self._round += 1
        return self.records
