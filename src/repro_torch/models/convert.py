"""Carry the reference's parameters over into the port's model.

:func:`params_from_jax` takes the tree ``repro.models.model.init_params``
returns, with every leaf as a numpy array (the caller converts; this
module imports no JAX).  Its layer leaves are stacked per segment:
``seg{si}/sub{i}/...`` with a leading ``repeats`` axis, and layer
``r · len(pattern) + i`` of a segment is slice ``r`` of ``sub{i}``.
Dense weights keep the reference's ``(d_in, d_out)`` orientation; they
are copied, not transposed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .config import ArchConfig
from .model import LanguageModel, LayerKind, layer_plan


def find_segments(kinds: List[LayerKind]) -> List[Tuple[Tuple[LayerKind, ...], int]]:
    """The reference's factoring of the layer plan into (superblock
    pattern, repeats) segments, which fixes how its leaves are stacked."""
    n = len(kinds)
    for p in range(1, min(16, n) + 1):
        if n % p == 0 and n // p > 1 \
                and all(kinds[i] == kinds[i % p] for i in range(n)):
            return [(tuple(kinds[:p]), n // p)]
    segs: List[Tuple[Tuple[LayerKind, ...], int]] = []
    i = 0
    while i < n:
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        segs.append(((kinds[i],), j - i))
        i = j
    return segs


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _copy(dst: torch.Tensor, src) -> None:
    src = _tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit parameter "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def params_from_jax(cfg: ArchConfig, tree: dict,
                    device="cpu") -> LanguageModel:
    """A :class:`LanguageModel` on ``device`` holding the reference's
    weights, in the dtype of the tree's embedding."""
    dtype = _tensor(tree["embed"]).dtype
    model = LanguageModel(cfg, torch.Generator(device=device), dtype=dtype)
    _copy(model.embed, tree["embed"])
    _copy(model.final_norm, tree["final_norm"])
    if not cfg.tie_embeddings:
        _copy(model.lm_head, tree["lm_head"])
    layer = 0
    for si, (pattern, repeats) in enumerate(find_segments(layer_plan(cfg))):
        seg = tree[f"seg{si}"]
        for r in range(repeats):
            for i in range(len(pattern)):
                sub = seg[f"sub{i}"]
                dst = model.layers[layer + r * len(pattern) + i]
                _copy(dst.norm1, sub["norm1"][r])
                _copy(dst.norm2, sub["norm2"][r])
                for name, p in dst.attn.items():
                    _copy(p, sub["attn"][name][r])
                for name, p in dst.mlp.items():
                    _copy(p, sub["mlp"][name][r])
        layer += repeats * len(pattern)
    return model
