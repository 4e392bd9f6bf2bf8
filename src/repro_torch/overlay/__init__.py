"""The overlay control plane of the port (counterpart of ``repro.overlay``):

* :mod:`repro_torch.overlay.events` — churn traces and epoch-stamped
  neighbour-table deltas over the NDMP simulator;
* :mod:`repro_torch.overlay.controller` — :class:`OverlayController`:
  delta → schedule rebuild → hot-swapped mixer (global or per-rank)
  behind a schedule-keyed :class:`MixerCache`;
* :mod:`repro_torch.overlay.runtime` — :func:`joiner_donors`, the Fig. 18
  catch-up donors (the reference's ``ChurnTrainLoop`` waits for
  ROADMAP.md Queue 1 item 6).
"""

from . import controller, events, runtime
from .controller import ControlReport, MixerCache, OverlayController
from .events import ChurnEvent, ChurnTrace, DeltaTracker, TableDelta
from .runtime import joiner_donors

__all__ = [
    "controller", "events", "runtime",
    "ControlReport", "MixerCache", "OverlayController",
    "ChurnEvent", "ChurnTrace", "DeltaTracker", "TableDelta",
    "joiner_donors",
]
