"""Plain-PyTorch versions of the port's kernels: what the CPU tests run,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card.

Counterpart of ``repro/kernels/ref.py``.  The oracles of all nine
kernels (``weighted_mix``, ``flash_decode``, ``gather_mix``,
``mix_accumulate`` and the wire codec's ``quantize_block``,
``dequantize_block``, ``dequant_accumulate`` and ``gather_mix_int8``),
and the Mamba2 SSD scan's (:func:`ssd_scan_ref`, the sequential
recurrence, and :func:`ssd_chunked_ref`, the chunked dual form
``ssd_scan``'s kernel is held to) are here, with :func:`gather_table`,
which checks the two gathers' tables, :func:`round_matrix`, which
``gather_mix_int8`` runs outside its kernel (``gather_mix``'s register
body scatters its table inside its own), :func:`masked_weights`,
which ``weighted_mix`` runs outside its kernel, and :func:`padded_width`.
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


def masked_weights(weights: torch.Tensor, mask=None) -> torch.Tensor:
    """The f32 weights ``weighted_mix`` sums with: ``weights`` itself, or
    with a (K,) ``mask`` the surviving weights renormalized,
    ``w·m / Σ(w·m)``, and all zeros when nothing survives.  K scalar
    operations on the weights' device, with no read back to the host
    (``repro/kernels/weighted_mix.py:110-114``).

    The total is summed in f64 and rounded once to f32.  That sum is
    exact while the surviving weights lie within 2^(28 − ⌈log2 K⌉) of the
    largest, so host and device weights give the same bits whatever order
    each device's reduction takes."""
    w = weights.float()
    if mask is None:
        return w
    eff = w * mask.to(device=w.device, dtype=torch.float32)
    total = eff.sum(dtype=torch.float64).float()
    return torch.where(total > 0, eff / torch.where(total > 0, total, 1.0),
                       torch.zeros_like(eff))


def weighted_mix_ref(models: torch.Tensor, weights: torch.Tensor,
                     mask=None) -> torch.Tensor:
    """models (K, N), weights (K,) → Σ_k w_k·models[k] as (N,) in
    ``models.dtype``, with f32 math (``repro/kernels/ref.py:weighted_mix_ref``).

    The sum runs in the order k = 0 … K−1 from zero, each product rounded
    to f32 and then added, which is the CUDA kernel's order and rounding,
    so on the card the two agree bit for bit.  With ``mask``, the weights
    are :func:`masked_weights`'s (all masked → zeros)."""
    w = masked_weights(weights, mask)
    acc = torch.zeros(models.shape[1], dtype=torch.float32, device=models.device)
    for k in range(models.shape[0]):
        acc = acc + w[k] * models[k].float()
    return acc.to(models.dtype)


def gather_table(C: int, srcs, weights: torch.Tensor) -> torch.Tensor:
    """Check a (C, K1) ``(srcs, weights)`` gather table as the reference's
    ``round_matrix`` does and return ``srcs`` as a tensor.  Host ``srcs``
    (numpy or a sequence) are checked for range eagerly; a tensor
    ``srcs`` (the cohort case, where the table is data) is the caller's
    contract, as a traced one is in the reference."""
    if not isinstance(srcs, torch.Tensor):
        srcs = np.asarray(srcs, np.int64)
        if srcs.min() < 0 or srcs.max() >= C:
            raise ValueError(f"source rows out of range for {C} clients")
        srcs = torch.from_numpy(srcs)
    if srcs.shape[0] != C or tuple(weights.shape) != tuple(srcs.shape):
        raise ValueError(
            f"srcs {tuple(srcs.shape)} / weights {tuple(weights.shape)} do "
            f"not match {(C,)} clients")
    return srcs


def round_matrix(C: int, srcs, weights: torch.Tensor) -> torch.Tensor:
    """Scatter a (C, K1) ``(srcs, weights)`` gather table, checked by
    :func:`gather_table`, into the dense (C, C) f32 round-mixing matrix
    ``W[i, srcs[i, k]] += weights[i, k]`` on the weights' device
    (duplicate sources add).

    The port of ``repro/kernels/weighted_mix.py:round_matrix``."""
    srcs = gather_table(C, srcs, weights).to(device=weights.device, dtype=torch.int64)
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


def _fused_add_f32(acc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """acc + p rounded once to f32, as one fused multiply-add rounds it,
    for acc and p float64 tensors that hold their values exactly (acc an
    f32 value, p the product of two f32 values, which has at most 48
    significant bits).  The float64 sum is rounded to odd (the
    neighbour with an odd last bit whenever the sum is inexact, found
    from its exact error by TwoSum), after which one rounding to f32,
    half to even, is the correctly rounded sum: float64 carries more
    than 24 + 1 bits, so the earlier rounding cannot make a tie."""
    s = acc + p
    bb = s - acc
    err = (acc - (s - bb)) + (p - bb)          # exact: s + err == acc + p
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, away), s).float()


def mix_accumulate_ref(acc, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """acc (B, N) or None, x (B, N), w (B,) → ``acc + w·x`` in acc's dtype
    (``w·x`` in x's dtype when acc is None), f32 math.

    The reference's ``acc + x·w`` reaches the TPU kernel and XLA on the
    CPU as one fused multiply-add, rounded once; here the product of the
    two f32 values is formed exactly in float64 and the sum rounded once
    to f32 (:func:`_fused_add_f32`), so it is the fused result
    everywhere.  The init form is one f32 multiply, as in the
    reference."""
    wf = w.to(device=x.device, dtype=torch.float32)[:, None]
    if acc is None:
        return (x.float() * wf).to(x.dtype)
    return _fused_add_f32(acc.double(), x.double() * wf.double()).to(acc.dtype)


def padded_width(n: int, block: int) -> int:
    """The wire width of an ``n``-column buffer, ``ceil(n / block)·block``
    (``repro/kernels/wire_codec.py:padded_width``)."""
    if block < 1:
        raise ValueError("block must be >= 1")
    return -(-n // block) * block


def quantize_block_ref(x: torch.Tensor, block: int = 128, levels: int = 127,
                       with_residual: bool = False):
    """Encode x (B, N) float → ``(q, scales[, residual])`` under the block
    layout of ``repro/kernels/wire_codec.py:31-41``: q (B, NB·block) int8
    in [-levels, levels], scales (B, NB) bf16 (the stored scale
    s = bf16(max|block| / levels)), and the residual x − q·s_used (B, N)
    f32, where s_used is s, or 1 where s is 0.  The tail block is padded
    with zeros; both divisions are true IEEE ones and the rounding half
    to even, as ``jnp.round``'s."""
    if levels < 1:
        raise ValueError("levels must be >= 1")
    B, N = x.shape
    Np = padded_width(N, block)
    xp = torch.zeros((B, Np), dtype=torch.float32, device=x.device)
    xp[:, :N] = x
    xv = xp.view(B, Np // block, block)
    amax = xv.abs().amax(dim=2)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not always the IEEE quotient
    s = (amax / torch.full_like(amax, levels)).to(torch.bfloat16)
    s_used = s.float()
    s_used = torch.where(s_used > 0, s_used, torch.ones_like(s_used))[..., None]
    qf = torch.clamp(torch.round(xv / s_used), -levels, levels)
    q = qf.to(torch.int8).view(B, Np)
    if not with_residual:
        return q, s
    return q, s, (xv - qf * s_used).view(B, Np)[:, :N].contiguous()


def dequantize_block_ref(q: torch.Tensor, scales: torch.Tensor,
                         block: int = 128) -> torch.Tensor:
    """Decode ``(q, scales)`` → (B, NB·block) f32: ``q·s`` per block."""
    B, Nq = q.shape
    if Nq % block or tuple(scales.shape) != (B, Nq // block):
        raise ValueError(f"q {tuple(q.shape)} / scales {tuple(scales.shape)} do "
                         f"not agree with block {block}")
    deq = q.float().view(B, Nq // block, block) * scales.float()[..., None]
    return deq.view(B, Nq)


def gather_mix_int8_ref(q: torch.Tensor, scales: torch.Tensor, srcs,
                        weights: torch.Tensor, block: int = 128) -> torch.Tensor:
    """The round over an int8-block encoded (C, N) population: the decoded
    rows (:func:`dequantize_block_ref`) mixed by :func:`gather_mix_ref`,
    (C, NB·block) f32."""
    return gather_mix_ref(dequantize_block_ref(q, scales, block), srcs, weights)


def dequant_accumulate_ref(acc, q: torch.Tensor, scales: torch.Tensor,
                           w: torch.Tensor, block: int = 128) -> torch.Tensor:
    """The int8-block receive fold: ``acc + w[:, None]·dequant(q, scales)``
    over (B, N) rows, for q (B, Nq) int8, scales (B, Nq / block) bf16 and
    w (B,) (``repro/kernels/wire_codec.py:dequant_accumulate``).

    ``q·s`` is exact in f32 (8 bits times an 8-bit significand).  With
    ``acc`` (B, N), N ≤ Nq, f32 or bf16, the result has acc's width and
    dtype: the sum ``acc + w·(q·s)`` rounded once to f32, as one fused
    multiply-add rounds it (the reference's sum reaches XLA's CPU
    backend and the TPU as one; see :func:`_fused_add_f32`), then to
    acc's dtype.  With ``acc=None`` it is the init form ``w·(q·s)``, one
    f32 multiply, over the full wire width Nq in f32.  An acc wider than
    the wire raises ``ValueError``."""
    B, Nq = q.shape
    N = Nq if acc is None else acc.shape[1]
    if N > Nq:
        raise ValueError(f"acc width {N} exceeds wire width {Nq}")
    deq = dequantize_block_ref(q, scales, block)[:, :N]
    wf = w.to(device=q.device, dtype=torch.float32)[:, None]
    if acc is None:
        return deq * wf
    return _fused_add_f32(acc.double(), deq.double() * wf.double()).to(acc.dtype)


def chunk_len(S: int, chunk: int) -> int:
    """The SSD chunk: ``min(chunk, S)``, halved until it divides S (down
    to 1), as ``repro/models/ssm.py:_ssd_chunked`` and the TPU
    ``ssd_scan`` choose it."""
    if S < 1 or chunk < 1:
        raise ValueError(f"SSD scan needs S >= 1 and chunk >= 1, got S={S}, "
                         f"chunk={chunk}")
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The sequential SSD recurrence, the oracle
    (``repro/kernels/ref.py:ssd_scan_ref``): from a zero state,
    ``state = exp(dt_t·A)·state + dt_t·x_t ⊗ B_t`` and
    ``y_t = state · C_t`` at every step, f32 math, y in x's dtype.

    x (B, S, H, P); dt (B, S, H); A (H,); Bm, Cm (B, S, N)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    A = A.float()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        da = torch.exp(dtt * A[None, :])
        dbx = torch.einsum("bhp,bn,bh->bhpn", xt, Bm[:, t].float(), dtt)
        state = state * da[:, :, None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    init_state=None):
    """The chunked SSD dual form (``repro/models/ssm.py:_ssd_chunked``):
    x (B, S, H, P); dt (B, S, H) after softplus; A (H,) negative; Bm, Cm
    (B, S, N) single-group; ``init_state`` (B, H, P, N) or None (zeros).
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).

    Per chunk of Q rows (:func:`chunk_len`), with cs the inclusive
    cumsum of dt·A: the intra-chunk term (C·Bᵀ ∘ exp(cs_i − cs_j), j ≤ i,
    the causal mask applied before the exp)·(dt∘x), plus
    exp(cs_i)·C_i·(the state entering the chunk); the state is carried
    through the chunks by ``state·exp(cs_end) + Σ_j exp(cs_end − cs_j)·
    dt_j·x_j ⊗ B_j``.  f32 math throughout.  The (Q, Q) decay matrices
    are laid out (B, chunks, H, Q, Q) and masked and exponentiated in
    place, so the largest transient is one f32 tensor of that shape."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nc = S // Q
    dtf = dt.float()
    cs = (dtf * A.float()[None, None, :]).reshape(Bsz, nc, Q, H).cumsum(2)
    cs = cs.permute(0, 1, 3, 2)                              # (B, nc, H, Q)
    xdt = (x.float() * dtf[..., None]).reshape(Bsz, nc, Q, H, P)
    xdt = xdt.permute(0, 1, 3, 2, 4)                         # (B, nc, H, Q, P)
    Bc = Bm.float().reshape(Bsz, nc, 1, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, 1, Q, N)

    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = cs[..., :, None] - cs[..., None, :]                  # (B, nc, H, Q, Q)
    L.masked_fill_(~causal, float("-inf")).exp_()
    L.mul_(Cc @ Bc.transpose(-1, -2))                        # ∘ C·Bᵀ
    y = L @ xdt                                              # (B, nc, H, Q, P)
    del L

    decay_to_end = torch.exp(cs[..., -1:] - cs)              # (B, nc, H, Q)
    chunk_state = (xdt * decay_to_end[..., None]).transpose(-1, -2) @ Bc
    chunk_decay = torch.exp(cs[..., -1])                     # (B, nc, H)
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = torch.empty_like(chunk_state)                     # (B, nc, H, P, N)
    for c in range(nc):
        prev[:, c] = state
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    y += torch.exp(cs)[..., None] * (Cc @ prev.transpose(-1, -2))
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
    return y.to(x.dtype), state
