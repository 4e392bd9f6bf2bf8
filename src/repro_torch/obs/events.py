"""The process-local telemetry bus: typed counters, gauges, histograms,
and span events on a monotonic clock.

One :class:`Telemetry` instance is a bag of named instruments plus an
append-only event log.  Every runtime layer reports into whichever bus
it was handed (or the process-global default, see :func:`get_telemetry`)
**host-side only**: instruments are plain Python dict/float updates at
tick boundaries, never between a tick's device launches, so enabling
telemetry adds no device work and no synchronisation.

Disabled-by-default guarantee
-----------------------------
The global bus starts as :data:`NULL`, a no-op singleton whose methods
do nothing and allocate nothing (``enabled = False``).  Instrumented
code either calls the no-op methods directly (~a method call per tick)
or guards bigger argument construction behind ``bus.enabled``.

Clock
-----
All times come from :func:`time.perf_counter` (monotonic); events carry
seconds since bus creation, span durations are reported in
milliseconds.  Wall-clock timestamps are deliberately absent — stamp
them at export time if you need them.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

_CLOCK = time.perf_counter


@dataclasses.dataclass
class TelemetryEvent:
    """One point-in-time event: a name, seconds since bus creation, and
    free-form attributes (kept JSON-friendly by convention)."""

    name: str
    t: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "t": round(self.t, 6), **self.attrs}


class Histogram:
    """Streaming summary of an observed value (count/total/min/max).

    Deliberately not a bucketed histogram: the consumers here want
    per-round latency summaries and overhead accounting, and a four-
    float summary keeps ``observe`` allocation-free on the hot path."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "total": round(self.total, 6),
                "mean": round(self.mean, 6), "min": round(self.min, 6),
                "max": round(self.max, 6)}


class Telemetry:
    """A live telemetry bus.

    * :meth:`count` — monotone counters (``"serve.completed"``);
    * :meth:`gauge` — last-write-wins values (``"serve.occupancy"``);
    * :meth:`observe` — histogram samples;
    * :meth:`event` — timestamped structured events;
    * :meth:`span` — a context manager timing a host-side block, which
      feeds both a ``<name>.ms`` histogram and (optionally) an event.

    Naming convention: ``<layer>.<signal>`` with ``_ms`` / ``_bytes``
    suffixes on units — the round ledger (:mod:`repro_torch.obs.rounds`)
    joins counter *deltas* per round by these names.  Adding a new
    signal is one call at a tick boundary; no schema registration
    needed.
    """

    enabled = True

    def __init__(self, *, max_events: int = 100_000):
        self.t0 = _CLOCK()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.events: List[TelemetryEvent] = []
        self.max_events = max_events
        self.dropped_events = 0

    # ---- instruments -----------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        hist = self.histograms.get(name)
        if hist is None:
            hist = self.histograms[name] = Histogram()
        hist.observe(value)

    def event(self, name: str, **attrs) -> None:
        if len(self.events) >= self.max_events:
            self.dropped_events += 1
            return
        self.events.append(TelemetryEvent(name, _CLOCK() - self.t0, attrs))

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        """Time a host-side block into the ``<name>.ms`` histogram (and
        an event when attributes are given)."""
        t0 = _CLOCK()
        try:
            yield
        finally:
            ms = (_CLOCK() - t0) * 1e3
            self.observe(name + ".ms", ms)
            if attrs:
                self.event(name, ms=round(ms, 4), **attrs)

    # ---- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """A copy of the counter values — round ledgers diff successive
        snapshots to attribute control-plane activity per round."""
        return dict(self.counters)

    def summary(self) -> Dict[str, Any]:
        """JSON-friendly totals: counters, gauges, histogram summaries,
        and event counts (the shape BENCH JSON embeds)."""
        out: Dict[str, Any] = {}
        if self.counters:
            out["counters"] = {k: self.counters[k]
                               for k in sorted(self.counters)}
        if self.gauges:
            out["gauges"] = {k: self.gauges[k] for k in sorted(self.gauges)}
        if self.histograms:
            out["histograms"] = {k: self.histograms[k].summary()
                                 for k in sorted(self.histograms)}
        if self.events:
            out["num_events"] = len(self.events)
        if self.dropped_events:
            out["dropped_events"] = self.dropped_events
        return out


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTelemetry(Telemetry):
    """The disabled bus: every method is a no-op and nothing is ever
    allocated.  This is the process-global default — telemetry is
    strictly opt-in (:func:`enable` / an explicit ``telemetry=``)."""

    enabled = False

    def __init__(self):  # no state at all
        pass

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def event(self, name, **attrs):
        pass

    def span(self, name, **attrs):
        return _NULL_SPAN

    def snapshot(self):
        return {}

    def summary(self):
        return {}


#: The no-op singleton every layer sees until telemetry is enabled.
NULL = NullTelemetry()

_BUS: Telemetry = NULL


def get_telemetry() -> Telemetry:
    """The process-global bus (:data:`NULL` unless :func:`enable`\\ d)."""
    return _BUS


def set_telemetry(bus: Optional[Telemetry]) -> Telemetry:
    """Install ``bus`` (``None`` → :data:`NULL`) as the global bus and
    return the previous one."""
    global _BUS
    prev, _BUS = _BUS, (bus if bus is not None else NULL)
    return prev


def enable(bus: Optional[Telemetry] = None) -> Telemetry:
    """Turn the global bus on (a fresh :class:`Telemetry` unless one is
    given) and return it."""
    bus = bus if bus is not None else Telemetry()
    set_telemetry(bus)
    return bus


def disable() -> None:
    """Restore the disabled-by-default global state."""
    set_telemetry(None)


@contextmanager
def telemetry(bus: Optional[Telemetry] = None
              ) -> Iterator[Telemetry]:
    """Scoped :func:`enable`: install a bus for the ``with`` body and
    restore the previous global bus on exit (benchmark/test currency)."""
    bus = bus if bus is not None else Telemetry()
    prev = set_telemetry(bus)
    try:
        yield bus
    finally:
        set_telemetry(prev)
