"""The overlay control plane of the port (counterpart of ``repro.overlay``):

* :mod:`repro_torch.overlay.events` — churn traces and epoch-stamped
  neighbour-table deltas over the NDMP simulator;
* :mod:`repro_torch.overlay.controller` — :class:`OverlayController`:
  delta → schedule rebuild → hot-swapped mixer (global or per-rank)
  behind a schedule-keyed :class:`MixerCache`;
* :mod:`repro_torch.overlay.runtime` — :class:`ChurnTrainLoop`: the
  bundle's local step + the controller's mixer under a churn trace,
  re-stacked by node identity, with :func:`joiner_donors`, the Fig. 18
  catch-up donors.

The re-stacking loop builds a new stack at every membership change; its
static-shape sibling is :class:`repro_torch.runtime.SlotTrainLoop`
(masked dead slots, rows written in place).
"""

from . import controller, events, runtime
from .controller import ControlReport, MixerCache, OverlayController
from .events import ChurnEvent, ChurnTrace, DeltaTracker, TableDelta
from .runtime import ChurnStepRecord, ChurnTrainLoop, joiner_donors

__all__ = [
    "controller", "events", "runtime",
    "ControlReport", "MixerCache", "OverlayController",
    "ChurnEvent", "ChurnTrace", "DeltaTracker", "TableDelta",
    "ChurnStepRecord", "ChurnTrainLoop", "joiner_donors",
]
