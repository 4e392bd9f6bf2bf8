"""Shared building blocks, the port of ``repro/models/layers.py``.

Dense weights keep the reference's ``(d_in, d_out)`` orientation, so a
projection is ``x @ w``.  Products accumulate in float32 and come back in
the activation's dtype; norms and rotary embeddings compute in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """U(-1/sqrt(d_in), 1/sqrt(d_in)) drawn in float32, as the reference."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    return w.uniform_(-scale, scale, generator=gen).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) · 0.02 drawn in float32, as the reference."""
    w = torch.empty((vocab, d_model), dtype=torch.float32, device=gen.device)
    return (w.normal_(generator=gen) * 0.02).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype, returned in x's dtype.  A float32
    product is full float32 (TF32 is off, see ``resolve_device``); a
    bfloat16 product accumulates in float32 in cuBLAS and oneDNN."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * g.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding in the half-split form: x (..., seq, heads, hd) is
    cut into halves (x1, x2) along hd, not into interleaved pairs.
    ``positions`` broadcasts to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    h = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    return matmul(h, p["w_down"])


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  Through ``F.embedding``, whose
    backward sums each row's gradients in a fixed order on the CPU too
    (indexing's backward, an accumulating ``index_put_``, does not with
    more than one thread there), so a training run repeats bit for bit,
    which resuming from a checkpoint relies on."""
    return F.embedding(tokens, table)


def unembed_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32; table (vocab, d)."""
    return torch.matmul(x.float(), table.float().t())


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (..., V) f32, labels int
    (``repro/models/layers.py:117``)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
