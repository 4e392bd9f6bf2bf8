"""repro_torch.faults — deterministic fault injection + graceful degradation.

The port of ``repro.faults`` (pure numpy on the host; its data-plane
image is the ``edge_mask`` of the port's mixers).

Every failure the rest of the repo exercises is *clean*: scripted
churn, polite leaves, repair that succeeds on the first try.  This
package is the adversarial counterpart — a seed-reproducible fault
plane over both NDMP engines plus the degradation machinery (edge-mask
degraded mixing, bounded-backoff repair, suspect→evict→heal health
tracking, crash/resume) that survives it.

Failure-model contract
======================

**Fault classes.**  A :class:`~repro_torch.faults.plan.FaultPlan` declares,
once, everything that will go wrong in a run:

* *control-plane message faults* — each NDMP message is independently
  dropped with probability ``msg_loss``, delayed by
  ``delay_factor × latency`` with probability ``msg_delay``, or
  duplicated with probability ``msg_dup``;
* *partitions* — timed :class:`~repro_torch.faults.plan.Partition` windows
  during which cross-group messages are dropped (``symmetric=False``
  drops only traffic *from* ``groups[0]``, the asymmetric/one-way
  outage of unreliable D2D links);
* *crashes* — crash-without-leave at a scheduled time (the node
  vanishes silently; 3T heartbeat silence detects it);
* *rejoins* — a scheduled re-entry: an alive node re-anchors through a
  bootstrap (``rejoin``), a crashed node joins afresh;
* *data-plane faults* — per-edge :class:`~repro_torch.faults.plan.LinkOutage`
  windows and per-node :class:`~repro_torch.faults.plan.Straggler` windows.
  These never touch NDMP; they surface to the mixer as an
  unreachable-edge mask (below).

**Delivery and ordering guarantees.**  The transport under a plan is
*unreliable, unordered, at-least-once*: messages may be lost, delayed
arbitrarily (but never reordered relative to identical send times —
the simulator heap is FIFO per timestamp), or duplicated.  NDMP
tolerates all three by construction: handlers are idempotent, the
``improve_pointer`` rule is monotone (a stale or duplicated message can
never clobber a better pointer), joins retry until every space has
both pointers, and periodic bidirectional self-probes re-converge
concurrent damage.  What loss *cannot* do is corrupt a message or
forge a sender.

**Engine equivalence.**  A plan drives either engine behind the
:class:`repro_torch.core.ndmp.SimulatorProtocol` seam via
:class:`~repro_torch.faults.plan.ChaosEngine`: the object
:class:`~repro_torch.core.ndmp.Simulator` takes faults per message (a
transport filter seeded from the plan), the flat-array
:class:`~repro_torch.scale.ndmp_vec.VectorSimulator` takes their *converged
image* (loss ⇒ deadline stretch ~1/(1-p); partition ⇒ per-group ring
rebuilds; heal ⇒ one re-merge rebuild).  Because converged NDMP tables
are a pure function of visible membership, both engines reach
**table-identical** state once faults heal and the settle time passes
(``tests/test_torch_faults.py`` holds both to the reference's).  The vector engine models
partitions symmetrically (the converged approximation); the object
engine reproduces the asymmetric transient exactly.

**Recovery invariants.**

1. *Partition heal merges.*  After a full partition, failure detection
   prunes each side's address books, leaving internally-correct but
   disjoint overlays that probing alone can never reconnect.  The
   chaos engine's heal sweep re-joins every non-anchor side through a
   live cross-side bootstrap (:meth:`repro_torch.core.ndmp.Simulator.rejoin`);
   Theorem 1 splices each rejoiner at its globally closest coordinate
   and correctness returns to 1.0 within a settle window.
2. *Degraded rounds stay exact.*  Unreachable data-plane edges are
   dropped and the surviving weights renormalized via the existing
   runtime-weights path (``edge_mask`` on the masked mixers) —
   equal to the dense renormalized oracle
   (:func:`repro_torch.core.mixing.masked_mixing_matrix`) within 1e-6, with
   **zero reallocation** and the same
   :class:`~repro_torch.overlay.controller.MixerCache` entry: a fault storm
   never rebuilds anything.
3. *Repair is bounded, not assumed.*  The overlay controller retries
   NDMP repair under a :class:`~repro_torch.faults.degrade.BackoffPolicy`
   (decorrelated jitter) at most ``max_retries`` times, then gives up
   loudly (``faults.repair_gave_up``); the
   :class:`~repro_torch.faults.degrade.HealthTracker` carries each node
   through a **versioned** suspect → evicted → healthy lifecycle so a
   stale heal can never resurrect an evicted node out of order.
4. *Crash/resume is exact.*  :meth:`repro_torch.runtime.loop.SlotTrainLoop.save`
   / ``restore`` round-trip the full slot state (flat rows, optimizer
   state, top-k error-feedback residual, step counter) through
   :mod:`repro_torch.ckpt.checkpoint` bit-exactly; replaying the same seeds
   from a checkpoint is loss-parity ≤ 1e-6 with an uninterrupted run.

**Observability.**  Every injected fault and recovery action lands on
the :mod:`repro_torch.obs` bus as ``faults.*`` counters
(``msg_dropped/msg_delayed/msg_duped/msg_partitioned``, ``crashes``,
``rejoins``, ``partition_starts/partition_heals``,
``repair_retries/repair_recovered/repair_gave_up``,
``suspects/evictions/heals``, ``swap_barrier_aborts``) and as
per-round ``faults_injected`` / ``degraded_edges`` fields on the
:class:`repro_torch.obs.rounds.RoundRecord`, so ledgers show what was
injected vs. what was survived.  ``chip_smoke.py``'s ``churn`` phase
runs the reference's ``benchmarks/fault_storm.py`` arms (loss ×
partition × straggler) on the card, each held to its CPU twin.
"""

from .degrade import BackoffPolicy, HealthState, HealthTracker, RepairPolicy
from .plan import (ChaosEngine, DataFaults, FaultPlan, LinkOutage,
                   Partition, Straggler, edge_mask_for)

__all__ = [
    "BackoffPolicy", "ChaosEngine", "DataFaults", "FaultPlan",
    "HealthState", "HealthTracker", "LinkOutage", "Partition",
    "RepairPolicy", "Straggler", "edge_mask_for",
]
