"""Plain-PyTorch versions of the port's kernels: what the CPU tests run,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card.

Counterpart of ``repro/kernels/ref.py``.  Only the oracle of this
slice's kernel (``flash_decode``) is here so far; the others arrive with
the kernels that need them (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention of q (B, Hq, hd) against caches
    (B, L, Hkv, hd) under a (B, L) validity mask, f32 math, output in
    q's dtype.  The softmax row is multiplied by its mask, so a row with
    no valid entry comes out exactly zero."""
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,blhd->bhgl", qg, k_cache.float()) * (hd ** -0.5)
    mask = valid[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask
    out = torch.einsum("bhgl,blhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """q (B, Hq, hd) vs caches (B, L, Hkv, hd), prefix-valid ``idx <= pos``.

    ``pos`` is a scalar or a per-slot (B,) vector.  Valid entries are
    those with ``idx <= pos[b]`` and ``idx < L``; rows with ``pos < 0``
    are empty serving slots and come back exactly zero."""
    B = q.shape[0]
    L = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64)
    pos = pos.reshape(-1).expand(B)
    idx = torch.arange(L, device=q.device)
    return decode_attention_ref(q, k_cache, v_cache,
                                idx[None, :] <= pos[:, None])
