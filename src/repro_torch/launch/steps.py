"""The masked DFL local step of the slot runtime.

The port of the local half of ``repro/launch/steps.py:dfl_train_bundle``
(``local_updates`` and ``masked_local``, ``steps.py:323-348``): for every
live client, ``value_and_grad`` of :func:`repro_torch.models.model.train_loss`,
``clip_by_global_norm(·, 1.0)``, the optimizer update and the write.
The reference vmaps the step over the whole capacity axis and discards
the dead rows' results; here dead slots are skipped, so their parameter
and optimizer rows stay as they were, bit for bit.

The step works in place on the parameter tree it is given: in the slot
runtime's resident-flat mode those are views into the (capacity, N)
population buffer, so a client is neither copied into a module nor back.
Each client's gradients (one row of parameters' worth, leaf by leaf) are
the only allocation of its size.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..dist.flat import tree_flatten, tree_map, tree_unflatten
from ..models.config import ArchConfig
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
        device = tree_flatten(params)[0][0].device
        mean = (torch.stack(losses).mean() if losses
                else torch.zeros((), device=device))
        return params, opt_state, {"loss": mean,
                                   "num_alive": torch.tensor(float(len(live)))}
    return step
