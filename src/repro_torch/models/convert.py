"""Carry the reference's parameters over into the port's model, and map
a parameter tree in the reference's layout onto the model's state dict.

:func:`params_from_jax` takes the tree ``repro.models.model.init_params``
returns, with every leaf as a numpy array (the caller converts; this
module imports no JAX).  Its layer leaves are stacked per segment:
``seg{si}/sub{i}/...`` with a leading ``repeats`` axis, and layer
``r · len(pattern) + i`` of a segment is slice ``r`` of ``sub{i}``.
Dense weights keep the reference's ``(d_in, d_out)`` orientation; they
are copied, not transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ArchConfig
from .model import LanguageModel, find_segments, layer_plan


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def tree_from_numpy(tree, device="cpu"):
    """The reference's tree with numpy leaves (``jax.tree.map(np.asarray,
    tree)``) as the same nested dict of tensors on ``device``; bfloat16
    leaves stay bfloat16."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree).to(device)


def module_state(cfg: ArchConfig, tree: dict) -> Dict[str, torch.Tensor]:
    """The :class:`LanguageModel` state dict held by a parameter tree in
    the reference's layout (``init_params``, or ``FlatSpec.unravel_row``
    of a training row): each layer's entries are slices of the stacked
    leaves, so views stay views."""
    state = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = tree["lm_head"]
    layer = 0
    for si, (pattern, repeats) in enumerate(find_segments(layer_plan(cfg))):
        seg = tree[f"seg{si}"]
        for r in range(repeats):
            for i in range(len(pattern)):
                sub = seg[f"sub{i}"]
                name = f"layers.{layer + r * len(pattern) + i}"
                state[f"{name}.norm1"] = sub["norm1"][r]
                state[f"{name}.norm2"] = sub["norm2"][r]
                for group in ("attn", "mlp"):
                    for key, leaf in sub[group].items():
                        state[f"{name}.{group}.{key}"] = leaf[r]
        layer += repeats * len(pattern)
    return state


def params_from_jax(cfg: ArchConfig, tree: dict,
                    device="cpu") -> LanguageModel:
    """A :class:`LanguageModel` on ``device`` holding the reference's
    weights (a tree of numpy leaves), in the dtype of its embedding.
    Raises ``ValueError`` when a leaf does not fit its parameter."""
    state = module_state(cfg, tree_from_numpy(tree))
    model = LanguageModel(cfg, torch.Generator(device=device),
                          dtype=state["embed"].dtype)
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(f"the tree's leaves {sorted(set(state) ^ set(own))} "
                         f"do not match the model's parameters")
    for name, src in state.items():
        if tuple(src.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not fit "
                             f"parameter {tuple(own[name].shape)}")
    model.load_state_dict(state, strict=True)
    return model
