"""GQA attention, the port of ``repro/models/attention.py`` for the
dense decoder: projections with rotary embedding, the causal blockwise
prefill (optionally sliding-window), and single-token decode against a
KV cache.

Attention parameters are a dict-like ``p`` (an ``nn.ParameterDict`` in
the model) with ``wq``, ``wk``, ``wv``, ``wo`` in ``(d_in, d_out)``
orientation and, with qk-norm, ``q_norm`` / ``k_norm``.

Caches are ``{"k", "v"}`` tensors of shape (B, L, Hkv, hd).  Unlike the
reference, which returns a new cache, prefill and decode write into the
given tensors in place and return them: the serving loop allocates its
cache once.

Decode with ``window=None`` goes through :func:`flash_decode`, which on
a CUDA tensor is the hand-written kernel.  The windowed ring buffer and
the prefill attention stay plain PyTorch, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.flash_decode import flash_decode
from ..kernels.ref import NEG_INF, decode_attention_ref
from .layers import apply_rope, matmul, rmsnorm


def _project_qkv(p, x: torch.Tensor, num_heads: int, num_kv_heads: int,
                 head_dim: int, positions: torch.Tensor, rope_theta: float,
                 rms_eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = matmul(x, p["wq"]).reshape(B, S, num_heads, head_dim)
    k = matmul(x, p["wk"]).reshape(B, S, num_kv_heads, head_dim)
    v = matmul(x, p["wv"]).reshape(B, S, num_kv_heads, head_dim)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, rms_eps)
        k = rmsnorm(p["k_norm"], k, rms_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


# --------------------------------------------------------------------------
# Blockwise causal attention (prefill)
# --------------------------------------------------------------------------

def _pick_chunk(seq: int, preferred: int = 1024) -> int:
    c = min(seq, preferred)
    while seq % c:
        c //= 2
    return max(c, 1)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        causal: bool = True) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention with an online
    softmax over key chunks; peak memory O(B · Hq · chunk²).

    q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd).  Returns (B, S, Hq, hd) in
    q's dtype.  Under the causal mask a key chunk after the query chunk
    is entirely masked and adds exactly nothing, so it is skipped."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    C = chunk or _pick_chunk(S)
    nq = S // C
    scale = hd ** -0.5
    qc = q.reshape(B, nq, C, Hkv, G, hd).float()
    kc = k.reshape(B, nq, C, Hkv, hd).float()
    vc = v.reshape(B, nq, C, Hkv, hd).float()
    pos = torch.arange(S, device=q.device).reshape(nq, C)
    outs = []
    for i in range(nq):
        qb, qpos = qc[:, i], pos[i]
        m = torch.full((B, C, Hkv, G), NEG_INF, device=q.device)
        l = torch.zeros((B, C, Hkv, G), device=q.device)
        acc = torch.zeros((B, C, Hkv, G, hd), device=q.device)
        for j in range(i + 1 if causal else nq):
            kpos = pos[j]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kc[:, j]) * scale
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            else:
                mask = torch.ones((C, C), dtype=torch.bool, device=q.device)
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vc[:, j])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(B, S, Hq, hd)
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# Decode: one token against a (possibly ring-buffered) KV cache
# --------------------------------------------------------------------------

def _check_cache_overflow(pos, cache_len: int) -> None:
    """Raise when a host-known prefix-cache position is past the end.

    A position held on the card is not read back here, once per layer
    per token; the serving loop guards it on the host, as the reference
    does for its traced positions.  Ring-buffer reuse is the windowed
    path: prefix caches never wrap."""
    if isinstance(pos, torch.Tensor):
        if pos.device.type != "cpu":
            return
        p = pos.numpy()
    else:
        p = np.asarray(pos)
    if p.size and int(p.max()) >= cache_len:
        raise ValueError(
            f"decode position {int(p.max())} overflows the {cache_len}-slot "
            f"prefix KV cache; grow cache_len (or use a sliding window — "
            f"ring-buffer reuse is the windowed path)")


def _positions_vector(pos, batch: int, device) -> torch.Tensor:
    """Scalar-or-(B,) ``pos`` as a (B,) int64 vector on ``device``."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != batch):
        raise ValueError(
            f"pos must be a scalar or a ({batch},) per-slot vector, got "
            f"shape {tuple(pos.shape)}")
    return pos.to(torch.int64).reshape(-1).expand(batch)


def gqa_decode(p, x: torch.Tensor, cache: dict, pos, *, num_heads: int,
               num_kv_heads: int, head_dim: int, rope_theta: float,
               rms_eps: float = 1e-5,
               window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, D); ``pos``: a scalar absolute
    position shared by the batch, or a per-slot (B,) vector (rows with
    pos < 0 are empty slots: nothing valid, zero attention output, and
    the row's write lands inside its own dead cache row).  With a
    sliding window the cache is a ring of ``window`` slots; without one
    a host-known pos >= cache_len raises.  Writes this token's K/V into
    ``cache`` in place and returns (attn_out (B, 1, D), cache)."""
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    if window is None:
        _check_cache_overflow(pos, cache_len)
    pos_vec = _positions_vector(pos, B, x.device)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           pos_vec[:, None], rope_theta, rms_eps)
    kd, vd = k.to(ck.dtype), v.to(cv.dtype)
    slot = (pos_vec % cache_len if window is not None
            else pos_vec.clamp(0, cache_len - 1))
    if torch.as_tensor(pos).dim() == 0:
        # whole-batch position: one slot written for every row
        ck.index_copy_(1, slot[:1], kd)
        cv.index_copy_(1, slot[:1], vd)
    else:
        rows = torch.arange(B, device=x.device)
        ck[rows, slot] = kd[:, 0]
        cv[rows, slot] = vd[:, 0]
    if window is None:
        out = flash_decode(q[:, 0], ck, cv, pos)[:, None]
    else:
        out = cache_attention(q, ck, cv, pos, window=window)
    out = matmul(out.reshape(B, 1, num_heads * head_dim), p["wo"])
    return out, cache


def cache_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    pos, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, Hq, hd) vs cache (B, L, Hkv, hd) → (B, 1, Hq, hd), plain
    PyTorch.  Slot i holds absolute position i (no window) or, in a ring
    of L = window slots, is valid once written within the last
    ``window`` steps; rows with pos < 0 return exactly zero."""
    B, _, Hq, hd = q.shape
    L = ck.shape[1]
    pos_vec = _positions_vector(pos, B, q.device)
    idx = torch.arange(L, device=q.device)
    valid = idx[None, :] <= pos_vec[:, None]                     # (B, L)
    if window is not None:
        # ring buffer: every slot is valid once pos + 1 >= L
        valid = valid | (pos_vec[:, None] + 1 >= L)
    out = decode_attention_ref(q[:, 0], ck, cv, valid)
    return out[:, None]


def gqa_prefill(p, x: torch.Tensor, cache: dict, *, num_heads: int,
                num_kv_heads: int, head_dim: int, rope_theta: float,
                rms_eps: float = 1e-5,
                window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Whole-prompt prefill of x (B, P, D) at positions 0..P-1: writes
    every position's K/V into ``cache`` in place and attends causally
    within the prompt.  With a sliding window whose ring is shorter than
    P, only the last ``cache_len`` positions are written, at their ring
    slots (pos % cache_len).  Returns (attn_out (B, P, D), cache)."""
    B, P, _ = x.shape
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    if window is None and P > cache_len:
        raise ValueError(
            f"prompt length {P} overflows the {cache_len}-slot prefix KV "
            f"cache")
    positions = torch.arange(P, device=x.device)[None, :].expand(B, P)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, rms_eps)
    kd, vd = k.to(ck.dtype), v.to(cv.dtype)
    if P > cache_len:
        # ring layout of the last cache_len positions: slot s holds the
        # unique position in [P - cache_len, P) with pos % cache_len == s
        order = torch.as_tensor(
            np.argsort(np.arange(P - cache_len, P) % cache_len),
            device=x.device)
        ck.copy_(kd[:, P - cache_len:][:, order])
        cv.copy_(vd[:, P - cache_len:][:, order])
    else:
        ck[:, :P] = kd
        cv[:, :P] = vd
    out = blockwise_attention(q, k, v, window=window, causal=True)
    out = matmul(out.reshape(B, P, num_heads * head_dim), p["wo"])
    return out, cache
