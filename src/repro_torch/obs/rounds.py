"""The per-round ledger: one joined record per training round or serving
tick.

The port of ``repro/obs/rounds.py``.  Whichever loop drives the run
(:class:`~repro_torch.runtime.loop.SlotTrainLoop`,
:class:`~repro_torch.core.dfl.Engine`, ``launch/train.py`` or
:class:`~repro_torch.runtime.serving.ServeLoop`) emits one
:class:`RoundRecord` a round onto the ambient ledger (see
:func:`round_ledger`): control-plane signals (schedule rebuilds, swaps,
cache hits, churn membership, repair and commit latency) joined with
data-plane facts (wire and payload bytes per client from
:func:`repro_torch.dist.sync.sync_bytes_per_client`, the loss,
participation).

A ledger can additionally be bound to a :class:`~repro_torch.obs.events.
Telemetry` bus, in which case every record also carries the bus's
counter *deltas* since the previous record — ad-hoc counters added
anywhere in the stack show up per round with no ledger changes.

Export: :meth:`RoundLedger.to_jsonl` (one JSON object per line, the
``--telemetry-out`` format of ``launch/train.py``) and
:meth:`RoundLedger.summary_table` (a terminal table).
"""

from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .events import Telemetry, get_telemetry

#: The reference's training fields and their defaults.  A loop records
#: them as keywords of :meth:`RoundLedger.record`; the record keeps them
#: in ``extra`` (so a record's ``to_dict`` holds what its loop set and
#: nothing else) and reads them back as attributes, with these defaults.
TRAINING_FIELDS: Dict[str, Any] = {
    "time": 0.0, "loss": float("nan"), "wire_bytes_per_client": 0.0,
    "payload_bytes_per_client": 0.0, "swapped": False, "rebuilt": False,
    "cache_hit": False, "joined": (), "left": (), "repair_ms": 0.0,
    "commit_ms": 0.0, "faults_injected": 0, "degraded_edges": 0}


def _training_field(name: str, default):
    return property(lambda self: self.extra.get(name, default),
                    doc=f"``{name}`` as the loop recorded it ({default!r} when "
                        f"it did not).")


@dataclasses.dataclass
class RoundRecord:
    """One round: its index, the loop that drove it, how many slots were
    occupied and took part, and everything else under ``extra``.

    The reference's training fields (``time``, ``loss``,
    ``wire_bytes_per_client`` — what crosses links under the active
    codec — and ``payload_bytes_per_client`` — the same traffic in
    uncompressed model bytes —, ``swapped``, ``rebuilt``, ``cache_hit``,
    ``joined``, ``left``, ``repair_ms``, ``commit_ms``,
    ``faults_injected``, ``degraded_edges``) read as attributes with the
    reference's defaults (:data:`TRAINING_FIELDS`).  ``retraces`` and
    ``retrace_delta`` have no counterpart: the port's rule in their place
    is zero reallocation — the loops allocate their resident buffers
    once, which the tests hold by ``data_ptr`` — and there is no retrace
    to count."""

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


for _name, _default in TRAINING_FIELDS.items():
    setattr(RoundRecord, _name, _training_field(_name, _default))

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
        """Append one round.  Keyword fields other than the record's own
        (the training fields among them) land in ``extra``; bus counter
        deltas since the last record are merged in under their counter
        names."""
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

    # ---- export ----------------------------------------------------------
    def rows_as_dicts(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.rows]

    def to_jsonl(self, path) -> int:
        """Write one JSON object per round (strict JSON: NaN losses
        become null); returns the row count."""
        with open(path, "w") as fh:
            for row in self.rows:
                d = {k: (None if isinstance(v, float) and v != v else v)
                     for k, v in row.to_dict().items()}
                fh.write(json.dumps(d, sort_keys=True,
                                    default=_jsonable) + "\n")
        return len(self.rows)

    def summary(self) -> Dict[str, Any]:
        """Whole-run aggregates: the reference's, less ``retraces``."""
        if not self.rows:
            return {"rounds": 0}
        rows = self.rows
        wire = sum(r.wire_bytes_per_client for r in rows)
        payload = sum(r.payload_bytes_per_client for r in rows)
        losses = [r.loss for r in rows if r.loss == r.loss]  # drop NaN
        out = {
            "rounds": len(rows),
            "loop": rows[-1].loop,
            "final_loss": losses[-1] if losses else None,
            "num_alive_last": rows[-1].num_alive,
            "swaps": sum(1 for r in rows if r.swapped),
            "rebuilds": sum(1 for r in rows if r.rebuilt),
            "cache_hits": sum(1 for r in rows if r.cache_hit),
            "joins": sum(len(r.joined) for r in rows),
            "leaves": sum(len(r.left) for r in rows),
            "wire_mb_per_client": round(wire / 1e6, 6),
            "payload_mb_per_client": round(payload / 1e6, 6),
            "repair_ms_total": round(sum(r.repair_ms for r in rows), 3),
            "commit_ms_total": round(sum(r.commit_ms for r in rows), 3),
        }
        if wire and payload:
            out["wire_reduction"] = round(payload / wire, 3)
        return out

    def summary_table(self) -> str:
        """A terminal-friendly table of the run (header + aligned rows,
        capped at the last 20 rounds, plus a totals footer): the
        reference's, less its retrace column."""
        cols = ("round", "alive", "part", "loss", "wire_kb", "swap", "hit",
                "repair_ms", "commit_ms", "churn")
        lines = [self._fmt_row(cols)]
        lines.append(self._fmt_row(("-" * len(c) for c in cols)))
        shown = self.rows[-20:]
        if len(self.rows) > len(shown):
            lines.append(f"  ... {len(self.rows) - len(shown)} earlier "
                         "rounds elided ...")
        for r in shown:
            churn = ""
            if r.joined:
                churn += f"+{len(r.joined)}"
            if r.left:
                churn += f"-{len(r.left)}"
            lines.append(self._fmt_row((
                r.round, r.num_alive, r.participating,
                f"{r.loss:.4f}" if r.loss == r.loss else "-",
                f"{r.wire_bytes_per_client / 1e3:.1f}",
                "*" if r.swapped else "", "*" if r.cache_hit else "",
                f"{r.repair_ms:.2f}", f"{r.commit_ms:.2f}", churn)))
        s = self.summary()
        lines.append("")
        lines.append(
            f"rounds={s.get('rounds', 0)} swaps={s.get('swaps', 0)} "
            f"cache_hits={s.get('cache_hits', 0)} joins={s.get('joins', 0)} "
            f"leaves={s.get('leaves', 0)} "
            f"wire_mb/client={s.get('wire_mb_per_client', 0)}")
        return "\n".join(lines)

    @staticmethod
    def _fmt_row(cells) -> str:
        widths = (5, 5, 4, 9, 9, 4, 3, 9, 9, 6)
        return "  ".join(str(c).rjust(w) for c, w in zip(cells, widths))


def _jsonable(obj):
    try:
        return float(obj)
    except Exception:
        return str(obj)


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


@contextmanager
def disabled() -> Iterator[None]:
    """Force the fully-disabled state (the no-op bus, no global ledger)
    for the ``with`` body — the control arm of overhead measurements."""
    from .events import set_telemetry
    prev_bus = set_telemetry(None)
    prev_ledger = set_round_ledger(None)
    try:
        yield
    finally:
        set_telemetry(prev_bus)
        set_round_ledger(prev_ledger)
