"""The port's telemetry plane: copies of ``repro.obs.events`` and
``repro.obs.rounds`` (pure Python) and ``repro.obs.profile`` over
``torch.profiler``.

Disabled by default: the global bus is the no-op :data:`NULL` and the
global ledger None until a caller opts in (:func:`enable`,
:func:`telemetry`, :func:`round_ledger`, ``--telemetry-out``).
"""

from .events import (NULL, NullTelemetry, Telemetry, TelemetryEvent,
                     disable, enable, get_telemetry, set_telemetry,
                     telemetry)
from .profile import annotation, capture, scope
from .rounds import (RoundLedger, RoundRecord, disabled, get_round_ledger,
                     round_ledger, set_round_ledger)

__all__ = [
    "NULL", "NullTelemetry", "Telemetry", "TelemetryEvent",
    "disable", "enable", "get_telemetry", "set_telemetry", "telemetry",
    "annotation", "capture", "scope",
    "RoundLedger", "RoundRecord", "disabled", "get_round_ledger",
    "round_ledger", "set_round_ledger",
]
