"""Optimizers over trees of tensors: SGD (+momentum, Nesterov) and AdamW.

The port of ``repro/optim/optimizers.py``.  An optimizer is an
``(init, update)`` pair of plain functions over trees (nested dicts) of
tensors.  The reference's are pure; here the round works in place, so
that a step over a client's parameters allocates nothing of their size
beyond its gradients:

* ``update(grads, state, params) -> (updates, state)`` writes the new
  state into ``state``'s tensors and the updates into ``grads``'
  tensors (each update in its parameter's dtype, as the reference's
  ``apply_updates`` casts it), and returns both;
* :func:`apply_updates_` adds the updates into the parameters in place;
  :func:`apply_updates` is the out-of-place form;
* :func:`clip_by_global_norm` scales the gradients in place.

The AdamW state is the dict ``{"mu", "nu", "count"}``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..dist.flat import tree_flatten, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return () if momentum == 0.0 else _zeros_f32(params)

    def update(grads, state, params):
        g_leaves, treedef = tree_flatten(grads)
        p_leaves = tree_flatten(params)[0]
        m_leaves = tree_flatten(state)[0] if momentum else [None] * len(g_leaves)
        for g, p, m in zip(g_leaves, p_leaves, m_leaves):
            if weight_decay:
                g.add_(p.to(g.dtype), alpha=weight_decay)
            if momentum == 0.0:
                g.mul_(-lr)
                continue
            m.mul_(momentum).add_(g.float())
            if nesterov:                       # -lr * (momentum * m + g)
                g.copy_((momentum * m + g.float()).mul_(-lr))
            else:
                g.copy_(m * -lr)
        return grads, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          lr_schedule: Callable = None) -> Optimizer:
    def init(params):
        p0 = tree_flatten(params)[0][0]
        return {"mu": _zeros_f32(params), "nu": _zeros_f32(params),
                "count": torch.zeros((), dtype=torch.int32, device=p0.device)}

    def update(grads, state, params):
        state["count"].add_(1)
        count = state["count"].float()
        cur_lr = lr if lr_schedule is None else lr * lr_schedule(state["count"])
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        for g, m, v, p in zip(tree_flatten(grads)[0], tree_flatten(state["mu"])[0],
                              tree_flatten(state["nu"])[0], tree_flatten(params)[0]):
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            step = -cur_lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                              + weight_decay * p.float())
            g.copy_(step)
        return grads, state

    return Optimizer(init, update)


def apply_updates(params, updates):
    """params + updates (cast to each parameter's dtype), out of place."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def apply_updates_(params, updates):
    """params += updates in place; returns params."""
    for p, u in zip(tree_flatten(params)[0], tree_flatten(updates)[0]):
        p.add_(u.to(p.dtype))
    return params


def cosine_schedule(warmup: int, total: int, floor: float = 0.1) -> Callable:
    def sched(count):
        c = torch.as_tensor(count).float()
        warm = c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup, warm, cos)
    return sched


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_flatten(tree)[0]))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree_flatten(grads)[0]:
        g.mul_(scale.to(g.dtype))
    return grads, norm
