"""The Mamba2 mixer, the port of ``repro/models/ssm.py`` for serving.

A prefill runs the chunked SSD dual form over the whole prompt through
:func:`repro_torch.kernels.ssd_scan.ssd_scan` (the CUDA kernel on the
card, its plain chunked version on the CPU) and primes the decode cache
with the state after the last token and the conv tail; decode is the
O(1) recurrent step on that (B, H, P, N) state.

Parameters are a dict (or ``ParameterDict``) in the reference's layout:
``in_proj`` (D, 2·di + 2·N + H) projecting to [z, x, B, C, dt],
``conv_w`` (d_conv, di + 2·N), ``conv_b``, ``dt_bias``, ``A_log``, ``D``
(H,) f32, ``norm`` (di,), ``out_proj`` (di, D).  The cache is
``{"state": (B, H, P, N) f32, "conv": (B, d_conv − 1, di + 2·N)}``;
prefill and decode write it in place.

``mamba_apply``, the whole-sequence body of the reference's ``forward``
and ``train_loss``, waits for SSM training (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from .config import SSMConfig
from .layers import dense_init, matmul, rmsnorm


def mamba_init(gen: torch.Generator, d_model: int, s: SSMConfig,
               dtype=torch.float32) -> dict:
    """The reference's distributions (``repro/models/ssm.py:mamba_init``):
    ``in_proj`` and ``out_proj`` U(±1/sqrt(d_in)), ``conv_w`` N(0, 1) /
    d_conv, ``conv_b`` and ``dt_bias`` zeros, ``A_log`` log(1..H), ``D``
    and ``norm`` ones; ``dt_bias``, ``A_log`` and ``D`` are f32 whatever
    ``dtype``."""
    dev = gen.device
    di, nh = s.d_inner(d_model), s.nheads(d_model)
    conv_ch = di + 2 * s.d_state
    conv_w = torch.empty((s.d_conv, conv_ch), dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d_model, 2 * di + 2 * s.d_state + nh, dtype),
        "conv_w": (conv_w.normal_(generator=gen) * (1.0 / s.d_conv)).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d_model, dtype),
    }


def _split_proj(proj: torch.Tensor, di: int, n: int, nh: int):
    """Views of [z, x, B, C, dt] along the last dim of ``proj``."""
    z = proj[..., :di]
    x = proj[..., di:2 * di]
    Bm = proj[..., 2 * di:2 * di + n]
    Cm = proj[..., 2 * di + n:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    if dt.shape[-1] != nh:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt heads, expected {nh}")
    return z, x, Bm, Cm, dt


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, Ch) with taps (K, Ch), the
    sequence zero-padded on the left, then silu: tap i meets row
    t − (K − 1 − i).  No padded copy is made: each tap adds its shifted
    product into one output in place, in the reference's order of taps.
    (The reference's ``init`` argument, a (B, K − 1, Ch) prefix, has no
    caller there and is not ported.)"""
    K = w.shape[0]
    S = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(K):
        shift = K - 1 - i
        if shift < S:
            out[:, shift:].addcmul_(xbc[:, :S - shift], w[i][None, None, :])
    return F.silu(out + b[None, None, :])


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                state_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan (``repro/models/ssm.py:ssd_chunked``) from a
    zero state, through :func:`ssd_scan`: (y (B, S, H, P) in x's dtype,
    final state (B, H, P, N) f32, written into ``state_out`` when given).
    (The reference's ``init_state`` has no caller there and is not
    ported here; the plain ``ssd_chunked_ref`` keeps it.)"""
    return ssd_scan(x, dt, A, Bm, Cm, chunk, state_out=state_out)


def init_ssm_cache(batch: int, d_model: int, s: SSMConfig,
                   dtype=torch.float32, device=None) -> dict:
    """A fresh cache: the (B, H, P, N) f32 state and the (B, d_conv − 1,
    d_inner + 2·N) conv tail, zeros."""
    di, nh = s.d_inner(d_model), s.nheads(d_model)
    return {
        "state": torch.zeros((batch, nh, s.headdim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * s.d_state),
                            dtype=dtype, device=device),
    }


def _gate_out(p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              dtype, rms_eps: float) -> torch.Tensor:
    """(y + D·x) in ``dtype``, gated by silu(z), normed, projected out.
    y is updated in place when it is f32."""
    y = y.float().addcmul_(xh, p["D"][:, None]).to(dtype)
    y = y.reshape(*z.shape).mul_(F.silu(z))
    return matmul(rmsnorm(p["norm"], y, rms_eps), p["out_proj"])


def mamba_prefill(p, xin: torch.Tensor, cache: dict, s: SSMConfig,
                  rms_eps: float = 1e-5) -> Tuple[torch.Tensor, dict]:
    """Whole-prompt Mamba2 prefill over xin (B, S, D): one chunked SSD
    pass, which also writes into ``cache`` the state after the last token
    and the conv tail (the last d_conv − 1 pre-activation conv rows,
    zero-padded on the left as the causal conv saw them).  Fresh-cache
    semantics, as the reference's: the incoming cache is overwritten, not
    read.  Returns (out (B, S, D), cache)."""
    Bsz, S, D = xin.shape
    di, nh, n = s.d_inner(D), s.nheads(D), s.d_state
    proj = matmul(xin, p["in_proj"])
    z, _, _, _, dt = _split_proj(proj, di, n, nh)
    xbc_raw = proj[..., di:2 * di + 2 * n]          # [x, B, C], a view
    conv = cache["conv"]
    K = conv.shape[1] + 1
    m = min(S, K - 1)
    conv.zero_()
    conv[:, K - 1 - m:] = xbc_raw[:, S - m:]
    xbc = causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(Bsz, S, nh, s.headdim)           # a view of the conv output
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, state_out=cache["state"])
    return _gate_out(p, y, xh, z, xin.dtype, rms_eps), cache


def mamba_decode(p, xin: torch.Tensor, cache: dict, s: SSMConfig,
                 rms_eps: float = 1e-5) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent step over xin (B, 1, D), the cache's state and
    conv window advanced in place.  Returns (out (B, 1, D), cache)."""
    Bsz, _, D = xin.shape
    di, nh, n = s.d_inner(D), s.nheads(D), s.d_state
    proj = matmul(xin, p["in_proj"])
    z, _, _, _, dt = _split_proj(proj, di, n, nh)
    conv = cache["conv"]
    win = torch.cat([conv, proj[..., di:2 * di + 2 * n].to(conv.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", win, p["conv_w"].to(win.dtype)) + p["conv_b"]
    xbc = F.silu(out)[:, None, :]
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]           # (B, H)
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(Bsz, nh, s.headdim).float()
    state = cache["state"]
    state.mul_(torch.exp(dt * A[None, :])[:, :, None, None])
    state.add_(torch.einsum("bhp,bn,bh->bhpn", xh, Bm[:, 0].float(), dt))
    y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())
    conv.copy_(win[:, 1:])
    return _gate_out(p, y, xh, z, xin.dtype, rms_eps), cache
