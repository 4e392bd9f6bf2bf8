"""The live overlay controller: NDMP deltas → rebuilt, hot-swapped mixers.

The port of ``repro/overlay/controller.py`` with the global mixer kind
only (the shard_map factory, ``controller.py:130``, waits for ROADMAP.md
Queue 1 item 10; the bounded-repair policy and the multi-process swap
barrier of ``repro.faults`` wait for item 6).  Between training rounds
the controller

1. advances the discrete-event NDMP simulator (and applies any scheduled
   churn events),
2. polls the :class:`~repro_torch.overlay.events.DeltaTracker` for
   neighbor-table deltas,
3. on a membership delta, rebuilds the
   :class:`~repro_torch.core.mixing.PermuteSchedule` for the current
   alive set over the live NDMP coordinates, and
4. hot-swaps the mixer behind a schedule-keyed cache.  PyTorch runs
   eagerly, so a "compiled" mixer is a closure of
   :func:`repro_torch.dist.sync.global_mixer`; the cache keeps the
   reference's hit/miss accounting and its per-device constant tables.

In capacity mode (``capacity=C``, the slot runtime) the controller owns
a :class:`~repro_torch.runtime.slots.SlotMap`, pads every schedule to C
slots (dead slots self-loop with weight 1) and builds mask-aware mixers
``(params, mask) -> params``, so the data-plane shapes never change.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import OrderedDict
from typing import Callable, Iterable, Optional, Tuple

from ..core.coords import NodeAddress
from ..core.mixing import PermuteSchedule, pad_schedule, schedule_from_addresses
from ..core.ndmp import SimulatorProtocol
from ..obs.events import get_telemetry
from ..runtime.slots import SlotMap
from .events import ChurnEvent, ChurnTrace, DeltaTracker, TableDelta


class MixerCache:
    """Schedule-keyed LRU cache of mixers.

    Keys are ``(PermuteSchedule, fuse, codec)`` triples — schedules hash
    by their perms+weights digest, so two control epochs that converge to
    the same topology share one mixer.  ``maxsize`` bounds the cache
    under sustained churn."""

    def __init__(self, factory: Callable[[PermuteSchedule], Callable],
                 maxsize: int = 64):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self._factory = factory
        self._cache: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, sched: PermuteSchedule,
            fuse: Optional[str] = None,
            codec=None) -> Tuple[Callable, bool]:
        """(mixer, was_hit) for a (schedule, fuse mode, wire codec),
        building it on first sight."""
        key = (sched, fuse, codec)
        mixer = self._cache.get(key)
        if mixer is not None:
            self.hits += 1
            self._cache.move_to_end(key)
            return mixer, True
        self.misses += 1
        mixer = self._factory(sched)
        self._cache[key] = mixer
        while len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
            self.evictions += 1
        return mixer, False


def _global_mixer_factory(strategy: str = "fedlay", masked: bool = False,
                          fuse: Optional[str] = None, flat_io: bool = False):
    from ..dist.sync import global_mixer

    def build(sched: PermuteSchedule) -> Callable:
        return global_mixer(strategy, sched, masked=masked, fuse=fuse,
                            flat_io=flat_io)
    return build


@dataclasses.dataclass(frozen=True)
class _StagedSwap:
    """A fully built (but not yet live) data-plane state, waiting for
    :meth:`OverlayController.commit` at the next round boundary."""

    alive: Tuple[int, ...]
    alive_schedule: PermuteSchedule
    schedule: PermuteSchedule            # == alive_schedule unless capacity
    mixer: Callable
    plan: Optional[object]               # RemapPlan in capacity mode


@dataclasses.dataclass(frozen=True)
class ControlReport:
    """What one control step did."""

    epoch: int                     # delta epoch after this step
    time: float                    # simulator clock after this step
    alive: Tuple[int, ...]         # slot order: sorted live node ids
    delta: TableDelta
    swapped: bool                  # a different mixer is now live
    rebuilt: bool                  # a schedule was rebuilt host-side
    cache_hit: bool                # the mixer came out of the cache
    rebuild_ms: float              # host time spent building the schedule


class OverlayController:
    """Closes the loop between an NDMP engine (control plane) and the
    mixer (data plane).

    ``step(dt)`` advances NDMP by ``dt`` of simulated time, detects
    table deltas, and exposes the current mixer via :attr:`mixer`
    (hot-swapped only when the membership changed).  Schedules use
    uniform MEP profiles (the reference's default; its ``profiles_fn``
    has no caller in the port yet).

    ``capacity`` switches on fixed-capacity slot mode (above).
    ``double_buffered`` defers the swap to the round boundary: ``step()``
    stages the rebuilt schedule, mixer and slot remap plan, and
    :meth:`commit` makes them live.  ``fuse`` selects the mixing-round
    mode (``"flat"``: the flat-buffer ``gather_mix`` round) and keys the
    cache beside the schedule.  ``flat_io`` builds mixers that consume
    and produce the raveled (capacity, N) buffer directly (resident flat
    parameters; fedlay/ring with ``fuse="flat"`` only).  A wire
    ``codec`` raises ``NotImplementedError`` (ROADMAP.md Queue 1 item 7).
    """

    def __init__(self, sim: SimulatorProtocol, *,
                 strategy: str = "fedlay",
                 mixer_factory: Optional[
                     Callable[[PermuteSchedule], Callable]] = None,
                 capacity: Optional[int] = None,
                 double_buffered: bool = False,
                 fuse: Optional[str] = None,
                 codec=None,
                 flat_io: bool = False):
        from ..dist.sync import resolve_wire
        self.sim = sim
        self.tracker = DeltaTracker(sim)
        self.strategy = strategy
        self.capacity = capacity
        self.double_buffered = double_buffered
        self.codec, self.fuse = resolve_wire(codec, fuse)
        self.flat_io = bool(flat_io)
        if self.flat_io and self.fuse != "flat":
            raise ValueError("flat_io mixers need the flat fuse mode "
                             "(fuse='flat')")
        self.slots = SlotMap(capacity) if capacity is not None else None
        if mixer_factory is None:
            mixer_factory = _global_mixer_factory(
                strategy, masked=capacity is not None, fuse=self.fuse,
                flat_io=self.flat_io)
        self.cache = MixerCache(mixer_factory)
        self.rebuilds = 0
        self.swaps = 0
        self.last_commit_ms = 0.0
        self._alive: Tuple[int, ...] = ()
        self._schedule: Optional[PermuteSchedule] = None
        self._alive_schedule: Optional[PermuteSchedule] = None
        self._mixer: Optional[Callable] = None
        self._staged: Optional[_StagedSwap] = None
        self.last_plan = None
        # trace cursor: end of the last processed control window.  Starts
        # at -inf so events at or before the first window's start fire.
        self._applied_until = float("-inf")
        # initial build for the seed network (not counted as churn-driven
        # rebuild/swap activity); it commits at once even when
        # double-buffered
        self._refresh(force=True)
        self.commit()
        self.last_plan = None
        self.rebuilds = 0
        self.swaps = 0

    # ---- public state ----------------------------------------------------
    @property
    def alive(self) -> Tuple[int, ...]:
        """Sorted live node ids — slot ``i`` of the schedule hosts
        ``alive[i]``."""
        return self._alive

    @property
    def schedule(self) -> PermuteSchedule:
        """The live schedule — capacity-padded in capacity mode."""
        assert self._schedule is not None
        return self._schedule

    @property
    def alive_schedule(self) -> PermuteSchedule:
        """The live schedule over the alive set only (unpadded) — slot
        ``i`` hosts ``alive[i]``; donor selection works in this space."""
        assert self._alive_schedule is not None
        return self._alive_schedule

    def alive_mask(self):
        """(capacity,) 0/1 float32 alive mask (capacity mode only)."""
        assert self.slots is not None, "alive_mask needs capacity mode"
        return self.slots.alive_mask()

    @property
    def mixer(self) -> Callable:
        """The live mixer."""
        assert self._mixer is not None
        return self._mixer

    # ---- the control step ------------------------------------------------
    def step(self, dt: float,
             events: Iterable[ChurnEvent] = (),
             trace: Optional[ChurnTrace] = None) -> ControlReport:
        """One control interval: apply churn scheduled up to ``now+dt``
        and not yet processed, advance NDMP to ``now+dt``, then reconcile
        the data plane with the observed tables.  Only *membership*
        deltas force a rebuild: the schedule is a pure function of the
        alive set (+ profiles)."""
        t_end = self.sim.now + dt
        due = list(events)
        if trace is not None:
            due.extend(trace.between(self._applied_until, t_end))
        self._applied_until = max(self._applied_until, t_end)
        ChurnTrace.apply(self.sim, sorted(due, key=lambda e: e.time))
        self.sim.run_until(t_end)
        delta = self.tracker.poll()
        if self._staged is None:
            self.last_plan = None
        swapped, rebuilt, cache_hit, rebuild_ms, alive = self._refresh(
            force=bool(delta.joined or delta.left))
        bus = get_telemetry()
        if bus.enabled:
            if delta.joined:
                bus.count("overlay.churn_joins", len(delta.joined))
            if delta.left:
                bus.count("overlay.churn_leaves", len(delta.left))
            if rebuilt:
                bus.count("overlay.rebuilds")
                bus.observe("overlay.rebuild_ms", rebuild_ms)
            if swapped:
                bus.count("overlay.swaps")
            bus.count("overlay.cache_hits" if cache_hit
                      else "overlay.cache_misses")
        return ControlReport(
            epoch=self.tracker.epoch, time=self.sim.now,
            alive=alive, delta=delta, swapped=swapped,
            rebuilt=rebuilt, cache_hit=cache_hit, rebuild_ms=rebuild_ms)

    def commit(self):
        """Apply the staged swap at the round boundary (no-op unless
        ``double_buffered`` staged one).  Returns the
        :class:`~repro_torch.runtime.slots.RemapPlan` of the most recent
        applied membership change (None when membership is unchanged or
        outside capacity mode).  :attr:`last_commit_ms` afterwards holds
        the host time the swap took."""
        if self._staged is not None:
            staged, self._staged = self._staged, None
            t0 = _time.perf_counter()
            self._apply(staged)
            self.last_commit_ms = (_time.perf_counter() - t0) * 1e3
            bus = get_telemetry()
            if bus.enabled:
                bus.count("overlay.commits")
                bus.observe("overlay.commit_ms", self.last_commit_ms)
        else:
            self.last_commit_ms = 0.0
        return self.last_plan

    # ---- internals -------------------------------------------------------
    def _alive_addresses(self) -> Tuple[NodeAddress, ...]:
        return tuple(sorted(self.sim.alive_addresses(),
                            key=lambda a: a.node_id))

    def _refresh(self, force: bool) -> Tuple[bool, bool, bool, float,
                                             Tuple[int, ...]]:
        """Reconcile schedule+mixer with the live tables.  Returns
        (swapped, rebuilt, cache_hit, rebuild_ms, alive)."""
        if not force and self._schedule is not None:
            self._mixer, hit = self.cache.get(self._schedule, self.fuse,
                                              self.codec)
            alive = (self._staged.alive if self._staged is not None
                     else self._alive)
            return False, False, hit, 0.0, alive
        t0 = _time.perf_counter()
        addrs = self._alive_addresses()
        alive = tuple(a.node_id for a in addrs)
        alive_sched = schedule_from_addresses(addrs)
        plan = None
        sched = alive_sched
        if self.slots is not None:
            plan = self.slots.plan(alive)
            slot_of = plan.slot_of
            sched = pad_schedule(alive_sched, [slot_of[u] for u in alive],
                                 self.capacity)
        rebuild_ms = (_time.perf_counter() - t0) * 1e3
        self.rebuilds += 1
        mixer, hit = self.cache.get(sched, self.fuse, self.codec)
        swapped = sched != self._schedule
        if swapped:
            self.swaps += 1
        staged = _StagedSwap(alive=alive, alive_schedule=alive_sched,
                             schedule=sched, mixer=mixer, plan=plan)
        if self.double_buffered:
            self._staged = staged
        else:
            self._apply(staged)
        return swapped, True, hit, rebuild_ms, alive

    def _apply(self, staged: _StagedSwap) -> None:
        """Make a staged swap live (slot remap, schedule, mixer)."""
        if staged.plan is not None:
            self.slots.apply(staged.plan)
            self.last_plan = staged.plan if staged.plan.changed else None
        self._alive = staged.alive
        self._alive_schedule = staged.alive_schedule
        self._schedule = staged.schedule
        self._mixer = staged.mixer
