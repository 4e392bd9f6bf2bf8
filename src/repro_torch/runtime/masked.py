"""Mask-aware helpers: what the slot runtime computes per round against a
static-capacity client axis with some slots dead.

The port of ``repro/runtime/masked.py``.  One convention: a (capacity,)
0/1 float32 vector, 1 = live and participating.

* the **local step**: :func:`masked_local_step` gates a functional
  step's parameter and optimizer updates with ``where`` (dead rows stay
  as they were, bit for bit; a NaN on a dead slot cannot leak into live
  state or metrics) and reduces per-client metrics with
  :func:`masked_mean`;
* the **mixer**: :func:`repro_torch.dist.sync.global_mixer` with
  ``masked=True`` over a :func:`pad_to_capacity` schedule takes the mask
  as a runtime input;
* **multirate participation**: :func:`participation_mask` evaluates
  ``t % k_u == 0`` on the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.mixing import PermuteSchedule, pad_schedule
from ..dist.flat import tree_flatten, tree_map


def broadcast_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape a (C,) mask to broadcast against a (C, ...) leaf."""
    return mask.reshape((leaf.shape[0],) + (1,) * (leaf.dim() - 1))


def masked_where(mask: torch.Tensor, new, old):
    """Per-row select: new where mask > 0, old elsewhere (tree-mapped)."""
    return tree_map(
        lambda n, o: torch.where(broadcast_mask(mask, n) > 0, n, o), new, old)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over live rows only.  Dead rows are zeroed with
    ``where`` before the sum, so a NaN on a dead slot cannot poison it."""
    m = mask.float()
    mm = broadcast_mask(m, values)
    v = torch.where(mm > 0, values.float(), torch.zeros((), device=values.device))
    return v.sum() / torch.clamp(mm.sum() * (values.numel() // m.numel()), min=1.0)


def masked_local_step(step: Callable) -> Callable:
    """Wrap a functional stacked local step ``(params, opt_state, batch)
    -> (params, opt_state, metrics)`` — it returns new tensors, and its
    per-client metrics carry the leading client dim — into its
    mask-aware sibling ``(params, opt_state, batch, mask) -> ...``.

    Dead slots still compute, but their updates are discarded: params
    and optimizer rows are ``where``-gated back to their previous
    values, and metrics whose leading dim matches the mask are
    masked-mean reduced."""

    def masked_step(params, opt_state, batch, mask):
        device = tree_flatten(params)[0][0].device
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
        new_params, new_opt, metrics = step(params, opt_state, batch)
        new_params = masked_where(mask, new_params, params)
        new_opt = masked_where(mask, new_opt, opt_state)
        n = mask.shape[0]
        metrics = tree_map(
            lambda v: (masked_mean(v, mask)
                       if v.dim() >= 1 and v.shape[0] == n else v), metrics)
        return new_params, new_opt, metrics
    return masked_step


def pad_to_capacity(sched: PermuteSchedule, slots) -> PermuteSchedule:
    """Pad an alive-set schedule to a :class:`~repro_torch.runtime.slots
    .SlotMap`'s capacity.  ``sched`` slot order must be the map's live
    nodes in **sorted id order** (the overlay controller's convention).
    Dead capacity slots self-loop with weight 1."""
    alive_sorted = sorted(slots.slot_of)
    if len(alive_sorted) != sched.num_clients:
        raise ValueError(
            f"schedule is for {sched.num_clients} clients, slot map "
            f"holds {len(alive_sorted)}")
    assignment = [slots.slot_of[u] for u in alive_sorted]
    return pad_schedule(sched, assignment, slots.capacity)


def participation_mask(mults: Sequence[int], step, device="cpu") -> torch.Tensor:
    """Multirate participation on ``device``: 1 where ``step % k_u == 0``.
    ``mults`` is the host-static
    :func:`repro_torch.core.mixing.participation_mults` vector; ``step``
    may be a tensor."""
    k = torch.as_tensor(np.asarray(mults, dtype=np.int64), device=device)
    return (torch.as_tensor(step, device=device) % k == 0).float()
