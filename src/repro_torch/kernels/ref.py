"""Plain-PyTorch versions of the port's kernels: what the CPU tests run,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card.

Counterpart of ``repro/kernels/ref.py``.  The oracles of the ported
kernels (``flash_decode``, ``gather_mix``) are here, with
:func:`round_matrix`, which ``gather_mix`` runs outside its kernel; the
others arrive with the kernels that need them (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import numpy as np
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


def round_matrix(C: int, srcs, weights: torch.Tensor) -> torch.Tensor:
    """Scatter a (C, K1) ``(srcs, weights)`` gather table into the dense
    (C, C) f32 round-mixing matrix ``W[i, srcs[i, k]] += weights[i, k]``
    on the weights' device (duplicate sources add).

    The port of ``repro/kernels/weighted_mix.py:round_matrix``.  Host
    ``srcs`` (numpy or a sequence) are checked for range eagerly; a
    tensor ``srcs`` (the cohort case, where the table is data) is the
    caller's contract, as a traced one is in the reference."""
    if not isinstance(srcs, torch.Tensor):
        srcs = np.asarray(srcs, np.int64)
        if srcs.min() < 0 or srcs.max() >= C:
            raise ValueError(f"source rows out of range for {C} clients")
        srcs = torch.from_numpy(srcs)
    if srcs.shape[0] != C or tuple(weights.shape) != tuple(srcs.shape):
        raise ValueError(
            f"srcs {tuple(srcs.shape)} / weights {tuple(weights.shape)} do "
            f"not match {(C,)} clients")
    srcs = srcs.to(device=weights.device, dtype=torch.int64)
    rows = torch.arange(C, device=weights.device)[:, None].expand(srcs.shape)
    W = torch.zeros((C, C), dtype=torch.float32, device=weights.device)
    return W.index_put_((rows, srcs), weights.float(), accumulate=True)


def gather_mix_ref(buf: torch.Tensor, srcs, weights: torch.Tensor) -> torch.Tensor:
    """buf (C, N), srcs (C, K1) ints, weights (C, K1) →
    out[i] = Σ_k weights[i, k]·buf[srcs[i, k]], f32 math, in buf.dtype.
    It gathers a (C, K1, N) f32 temporary, as the reference's oracle
    (``repro/kernels/ref.py:gather_mix_ref``) does."""
    idx = torch.as_tensor(np.asarray(srcs) if not isinstance(srcs, torch.Tensor)
                          else srcs, device=buf.device).long()
    gathered = buf.float()[idx]                                 # (C, K1, N)
    acc = (gathered * weights.float()[..., None]).sum(dim=1)
    return acc.to(buf.dtype)
