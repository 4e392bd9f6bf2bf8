"""The per-round ledger: one record per serving tick.

:class:`~repro_torch.runtime.serving.ServeLoop` emits one
:class:`RoundRecord` per tick onto the ambient ledger (see
:func:`round_ledger`), with the slot occupancy and, under ``extra``, the
tick's admissions, completions, evictions and queue depth.

A ledger can additionally be bound to a :class:`~repro_torch.obs.events.
Telemetry` bus, in which case every record also carries the bus's
counter *deltas* since the previous record — ad-hoc counters added
anywhere in the stack show up per round with no ledger changes.

The port of ``repro/obs/rounds.py``, cut to the fields the serving loop
records; the training loops' fields arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .events import Telemetry, get_telemetry


@dataclasses.dataclass
class RoundRecord:
    """One round: its index, the loop that drove it, how many slots
    were occupied, and everything else under ``extra``."""

    round: int
    loop: str
    num_alive: int = 0
    participating: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        for k, v in extra.items():
            d.setdefault(k, v)
        return d


_FIELDS = {f.name for f in dataclasses.fields(RoundRecord)} - {"extra"}


class RoundLedger:
    """Collects :class:`RoundRecord`\\ s for one run.

    ``bus`` (default: the process-global telemetry bus) supplies counter
    deltas: each :meth:`record` call diffs the bus's counters against
    the snapshot taken at the previous record and stores the non-zero
    deltas in the record's ``extra`` — so e.g. ``serve.evictions``
    incremented during tick k shows up on tick k's row."""

    def __init__(self, bus: Optional[Telemetry] = None):
        self.bus = bus
        self.rows: List[RoundRecord] = []
        self._last_counters: Optional[Dict[str, float]] = None

    def _resolve_bus(self) -> Telemetry:
        return self.bus if self.bus is not None else get_telemetry()

    def record(self, **fields) -> RoundRecord:
        """Append one round.  Unknown keyword fields land in ``extra``;
        bus counter deltas since the last record are merged in under
        their counter names."""
        extra = dict(fields.pop("extra", {}))
        for key in list(fields):
            if key not in _FIELDS:
                extra[key] = fields.pop(key)
        bus = self._resolve_bus()
        if bus.enabled:
            now = bus.snapshot()
            prev = self._last_counters or {}
            for name, value in now.items():
                delta = value - prev.get(name, 0)
                if delta:
                    extra.setdefault(name, delta)
            self._last_counters = now
        rec = RoundRecord(extra=extra, **fields)
        self.rows.append(rec)
        return rec

    def __len__(self) -> int:
        return len(self.rows)

    def summary(self) -> Dict[str, Any]:
        """Whole-run aggregates."""
        if not self.rows:
            return {"rounds": 0}
        return {"rounds": len(self.rows), "loop": self.rows[-1].loop,
                "num_alive_last": self.rows[-1].num_alive}


# ---- process-global ledger (mirrors the global telemetry bus) ------------

_LEDGER: Optional[RoundLedger] = None


def get_round_ledger() -> Optional[RoundLedger]:
    """The process-global ledger, or None (the default — loops only pay
    ledger bookkeeping when one is installed)."""
    return _LEDGER


def set_round_ledger(ledger: Optional[RoundLedger]) -> Optional[RoundLedger]:
    global _LEDGER
    prev, _LEDGER = _LEDGER, ledger
    return prev


@contextmanager
def round_ledger(ledger: Optional[RoundLedger] = None
                 ) -> Iterator[RoundLedger]:
    """Scoped global ledger: install for the ``with`` body, restore the
    previous one on exit."""
    ledger = ledger if ledger is not None else RoundLedger()
    prev = set_round_ledger(ledger)
    try:
        yield ledger
    finally:
        set_round_ledger(prev)
