"""Population-scale overlay engine: vectorized NDMP + cohort streaming.

The core reproduction (``repro_torch.core`` / ``repro_torch.overlay`` /
``repro_torch.runtime``) is exact but object-per-node: the discrete-event
:class:`repro_torch.core.ndmp.Simulator` tops out around 10^3 nodes, three
orders of magnitude short of the paper's "millions of users" ambition.
This package closes that gap with two layers behind the same seams the
rest of the stack already consumes.

Flat-array state layout (``ndmp_vec``)
--------------------------------------
:class:`~repro_torch.scale.ndmp_vec.VectorSimulator` re-expresses the NDMP
node population as a struct-of-arrays over **rows** (a row is a node
identity's permanent index, assigned at first join and reused on
fail→rejoin):

* ``ids``       (N,)   int64    node id of each row
* ``coords``    (N, L) float64  virtual coordinates, bit-exact with
  :func:`repro_torch.core.coords.coordinate` via the vectorized FNV-1a batch
  hasher (:func:`repro_torch.core.coords.coordinates_batch`)
* ``alive``     (N,)   bool     current membership (flips at the
  join/leave/fail call, like the object simulator)
* ``succ/pred`` (L, N) int64    ring pointers as **row indices**, −1 =
  unset; exported as node ids through ``neighbor_tables()`` /
  ``export_state()``
* ``version``   (N,)   int64    per-row pointer-rewrite counts (the
  cheap change stamp, same contract as ``NodeState.version``)
* ``confidence``(N,)   float32  per-row MEP confidence used by cohort
  sampling and donor selection

Membership changes are **batched** (``join_batch`` / ``leave_batch`` /
``fail_batch``); pointer repair is **vectorized**: when a repair
deadline fires, every ring's adjacency is recomputed in one
lexsort+roll over the rows visible at that instant, and versions bump
only where a pointer actually changed.  Repair *timing* follows the
object simulator's constants (join splice after the greedy-route
latency, leave splice after one notify round-trip, failure repair after
the 3T silence deadline), so ``correctness()`` dips and recovers on the
same schedule — while the converged tables are exactly the Definition-1
ring adjacency both engines agree on (Theorems 1–2), which is what the
vec-vs-object parity suite pins.

Cohort-weighting contract (``cohort``)
--------------------------------------
The streaming runtime trains a fixed-capacity device mesh against an
arbitrarily large overlay: each round a
:class:`~repro_torch.scale.cohort.CohortSampler` draws K alive nodes, the
:class:`~repro_torch.runtime.slots.SlotMap` turns the cohort delta into an
identity-preserving RemapPlan (stream-in/out as in-place row writes,
Fig-18 donor catch-up for cold slots), and mixing runs on the
**induced subgraph** of the full overlay: cohort member u averages over
``({u} ∪ N(u)) ∩ cohort`` with its schedule weights renormalized over
the present neighbors (absent neighbors' mass redistributed
proportionally, exactly :func:`repro_torch.core.mixing.masked_mixing_matrix`
semantics).  On the device this is the runtime-weight ``gather_mix``
path — cohort composition is data, not code, so any sequence of
cohorts reuses the same two resident buffers — and with the full
population as the cohort it is provably the dense full-participation
mixing matrix, the small-n oracle the tests pin within 1e-6.
"""

from .cohort import CohortSampler, CohortStreamLoop, cohort_mixing_matrix
from .ndmp_vec import VectorSimulator

__all__ = [
    "CohortSampler",
    "CohortStreamLoop",
    "VectorSimulator",
    "cohort_mixing_matrix",
]
