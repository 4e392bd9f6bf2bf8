"""Assigned architecture configs (public-literature pool) + the paper's
own small client models.  ``get(name)`` / ``REGISTRY`` are the front
door; every config cites its source in ``CONFIG.source``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ArchConfig, INPUT_SHAPES, InputShape, reduce_for_smoke

from .mamba2_370m import CONFIG as mamba2_370m
from .qwen3_14b import CONFIG as qwen3_14b
from .llama3_405b import CONFIG as llama3_405b
from .qwen3_4b import CONFIG as qwen3_4b
from .llama3_2_3b import CONFIG as llama3_2_3b
from .chameleon_34b import CONFIG as chameleon_34b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .phi3_5_moe import CONFIG as phi3_5_moe
from .jamba_1_5_large import CONFIG as jamba_1_5_large

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in [
        mamba2_370m, qwen3_14b, llama3_405b, qwen3_4b, llama3_2_3b,
        chameleon_34b, seamless_m4t_medium, deepseek_v3_671b, phi3_5_moe,
        jamba_1_5_large,
    ]
}


def tiny_lm(vocab: int = 512, d_model: int = 128, layers: int = 4) -> ArchConfig:
    """The small dense LM of the training front door
    (``launch/train.py``, which re-exports this object) and of the
    serving CLI's ``--arch tiny``.  The JAX package defines it in
    ``repro/launch/train.py``; it lives here so that the serving entry
    point need not import the training one."""
    return ArchConfig(name="tiny-lm", family="dense", num_layers=layers,
                      d_model=d_model, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=4 * d_model, vocab_size=vocab,
                      tie_embeddings=True, rope_theta=10_000.0)


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Shape-conditioned variant of an architecture.

    ``long_500k`` requires sub-quadratic attention: SSM/hybrid run
    natively; every attention architecture switches to the
    sliding-window variant (window 8192) so the 500k decode cache is
    O(window) — recorded as ``attn=sliding`` in the dry-run table.
    """
    if shape.name == "long_500k" and cfg.family != "ssm" and cfg.hybrid is None:
        return dataclasses.replace(cfg, sliding_window=8192)
    if shape.name == "long_500k" and cfg.hybrid is not None:
        # hybrid: mamba layers carry the long context; attention layers
        # use a window so their cache stays bounded (Jamba's design).
        return dataclasses.replace(cfg, sliding_window=8192)
    return cfg


__all__ = ["REGISTRY", "get", "for_shape", "INPUT_SHAPES", "reduce_for_smoke",
           "tiny_lm"]
