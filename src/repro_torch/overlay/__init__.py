"""The overlay control plane of the port: churn traces, table deltas,
and the controller that turns NDMP deltas into hot-swapped mixers
(counterpart of ``repro.overlay``)."""
