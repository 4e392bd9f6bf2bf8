"""Step builders of the DFL training round.

The port of ``repro/launch/steps.py``, in part:

* :func:`dfl_local_step` — the local half of ``dfl_train_bundle``
  (``local_updates`` and ``masked_local``, ``steps.py:323-348``): for
  every live client, ``value_and_grad`` of
  :func:`repro_torch.models.model.train_loss`, ``clip_by_global_norm(·,
  1.0)``, the optimizer update and the write.  The reference vmaps the
  step over the whole capacity axis and discards the dead rows' results;
  here dead slots are skipped, so their parameter and optimizer rows
  stay as they were, bit for bit.
* :func:`dfl_train_bundle` — the whole round for C clients on one
  device: that local step, then
  :func:`repro_torch.dist.sync.global_mixer`.

The local step works in place on the parameter tree it is given: in the
slot runtime's resident-flat mode those are views into the (capacity, N)
population buffer, so a client is neither copied into a module nor back.
Each client's gradients (one row of parameters' worth, leaf by leaf) are
the only allocation of its size, and are freed before the next client's
pass begins.

The reference's ``train_bundle``, ``prefill_bundle``, ``serve_bundle``,
``bundle_for`` and ``jit_bundle``, and the sharding specs of its
``StepBundle``, wait for the port's dry run (ROADMAP.md Queue 1 item
11): the port shards no model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.mixing import PermuteSchedule, build_permute_schedule
from ..dist.flat import tree_flatten, tree_map, tree_unflatten
from ..dist.sync import SYNC_STRATEGIES, global_mixer, resolve_wire, ring_schedule
from ..models.config import ArchConfig, InputShape
from ..models.model import train_loss
from ..optim.optimizers import Optimizer, apply_updates_, clip_by_global_norm


def dfl_local_step(cfg: ArchConfig, optimizer: Optimizer) -> Callable:
    """The mask-aware local step ``(params, opt_state, batch, mask) ->
    (params, opt_state, metrics)`` over a capacity-stacked parameter
    tree in the reference's layout (leaves (C, ...)), a stacked optimizer
    state, and a batch ``{"tokens", "labels"}`` of (C, B, S) ints.

    ``mask`` is the (C,) 0/1 live mask (numpy or a tensor).  The
    parameters and optimizer state are updated in place and returned;
    ``metrics`` holds ``loss``, the mean over live clients (0 when none
    is live), and ``num_alive``."""

    def step(params, opt_state, batch, mask):
        live = np.flatnonzero(np.asarray(
            mask.cpu() if isinstance(mask, torch.Tensor) else mask) > 0)
        losses = []
        for c in live.tolist():
            p_row = tree_map(lambda l: l[c], params)
            o_row = tree_map(lambda l: l[c], opt_state)
            leaves, treedef = tree_flatten(p_row)
            xs = [l.detach().requires_grad_() for l in leaves]
            with torch.enable_grad():
                loss = train_loss(cfg, tree_unflatten(treedef, xs),
                                  {k: v[c] for k, v in batch.items()})
                grads = list(torch.autograd.grad(loss, xs))
            with torch.no_grad():
                grads, _ = clip_by_global_norm(grads, 1.0)
                updates, _ = optimizer.update(tree_unflatten(treedef, grads),
                                              o_row, p_row)
                apply_updates_(p_row, updates)
            losses.append(loss.detach())
            del grads, updates          # not held through the next client's pass
        device = tree_flatten(params)[0][0].device
        mean = (torch.stack(losses).mean() if losses
                else torch.zeros((), device=device))
        return params, opt_state, {"loss": mean,
                                   "num_alive": torch.tensor(float(len(live)))}
    return step


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A DFL training step, the overlay schedule it mixes over (None for
    allreduce and none), and whether it carries an error-feedback
    residual."""

    step: Callable
    sched: Optional[PermuteSchedule]
    error_feedback: bool


def dfl_train_bundle(cfg: ArchConfig, shape: InputShape, num_clients: int,
                     optimizer: Optimizer, sync: str = "fedlay",
                     num_spaces: int = 3,
                     sched: Optional[PermuteSchedule] = None,
                     masked: bool = False, fuse: Optional[str] = None,
                     codec=None) -> StepBundle:
    """The DFL round of ``repro/launch/steps.py:dfl_train_bundle``
    (``steps.py:211-407``) for ``num_clients`` C clients on one device:
    every client's local step (:func:`dfl_local_step`), then the mixing
    round of :func:`repro_torch.dist.sync.global_mixer` over the client
    axis.  ``num_clients`` takes the place of the reference's mesh, whose
    data axes size C there; ``shape.global_batch`` must divide over the
    C clients (the batch is (C, B/C, S)).

    ``sched`` overrides the overlay built here (fedlay:
    ``build_permute_schedule(C, num_spaces)``; ring: the identity ring);
    it applies to fedlay and ring only.  The step's signatures are the
    reference's:

    * ``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``;
    * ``masked=True`` adds a trailing (C,) 0/1 ``mask``: masked-out
      clients keep their parameters and optimizer rows, mixing drops them
      and renormalizes, and the metrics are the mean loss over live
      clients and ``num_alive``;
    * an error-feedback ``codec`` (implies ``fuse="flat"``) adds a
      trailing (C, N) f32 ``residual`` and returns it, updated in place,
      last.

    ``params`` is the (C, ...)-stacked tree and ``opt_state`` the stacked
    optimizer state; the local step updates both in place (the returned
    optimizer state is the one given), and the mixing round returns new
    parameter tensors.  ``fuse="flat"`` runs the round as one
    ``gather_mix`` launch over the raveled (C, N) buffer (with int8-block,
    ``gather_mix_int8``)."""
    if sync not in SYNC_STRATEGIES:
        raise ValueError(
            f"unknown sync strategy {sync!r}; choose from {SYNC_STRATEGIES}")
    C = num_clients
    if shape.global_batch % C:
        raise ValueError(
            f"global batch {shape.global_batch} does not divide over {C} clients")
    if sched is not None:
        if sync not in ("fedlay", "ring"):
            raise ValueError(f"an explicit schedule only applies to fedlay/ring "
                             f"sync, not {sync!r}")
        if sched.num_clients != C:
            raise ValueError(f"schedule is for {sched.num_clients} clients, the "
                             f"bundle holds {C}")
    elif sync == "fedlay":
        sched = build_permute_schedule(C, num_spaces)
    elif sync == "ring":
        sched = ring_schedule(C)
    mix = global_mixer(sync, sched, masked=masked, fuse=fuse, codec=codec)
    wire_codec, _ = resolve_wire(codec, fuse)
    ef = (wire_codec is not None and wire_codec.error_feedback
          and sync in ("fedlay", "ring"))
    local = dfl_local_step(cfg, optimizer)

    if masked:
        def masked_train_step(params, opt_state, batch, mask, *residual):
            params, opt_state, metrics = local(params, opt_state, batch, mask)
            if ef:
                params, res = mix(params, mask, *residual)
                return params, opt_state, metrics, res
            return mix(params, mask), opt_state, metrics
        step = masked_train_step
    else:
        def train_step(params, opt_state, batch, *residual):
            # every row is a live client; with sync="none" the step takes
            # any number of rows, as the reference's vmapped step does
            everyone = np.ones(tree_flatten(params)[0][0].shape[0], np.float32)
            params, opt_state, metrics = local(params, opt_state, batch, everyone)
            metrics = {"loss": metrics["loss"]}
            if ef:
                params, res = mix(params, *residual)
                return params, opt_state, metrics, res
            return mix(params), opt_state, metrics
        step = train_step
    return StepBundle(step=step, sched=sched, error_feedback=ef)
