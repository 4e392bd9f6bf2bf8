"""The wire codec's kernels: block quantization, its decode, the fused
receive fold, and the mixing round over the encoded population.

The port of ``repro/kernels/wire_codec.py`` (Pallas TPU kernels):
:func:`quantize_block` (``csrc/quantize_block.cu``),
:func:`dequantize_block` (``csrc/dequantize_block.cu``),
:func:`dequant_accumulate` (``csrc/dequant_accumulate.cu``, the int8-block
receive of the per-rank mixer, :func:`repro_torch.dist.sync.fedlay_mix`)
and :func:`gather_mix_int8` (``csrc/gather_mix_int8.cu``, the global
round's); each source's header says what bounds it.

**Block layout** (``repro/kernels/wire_codec.py:31-41``): a (B, N) f32
buffer is cut along its columns into NB = ceil(N / block) blocks, the
tail padded with zeros; ``q`` is (B, NB·block) int8 and ``scales``
(B, NB) bf16, ``scales[b, j]`` covering columns j·block … (j+1)·block.
The scale is stored rounded to bf16 and quantization divides by that
stored value, so encode and decode agree exactly.

On a CUDA tensor each function launches its kernel and raises if the
build or the launch fails; on a CPU tensor it runs its plain version in
:mod:`repro_torch.kernels.ref`.  The kernels serve ``block`` 32, 64 and
128 (the codecs use 128) and raise for another; the plain versions take
any.  Each function counts its launches in ``<function>.launches``; the
plain path does not count.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .gather_mix import _sm_count
from .ref import (dequant_accumulate_ref, dequantize_block_ref, gather_mix_int8_ref,
                  padded_width, quantize_block_ref, round_matrix)

__all__ = ["padded_width", "quantize_block", "dequantize_block",
           "dequant_accumulate", "gather_mix_int8", "KERNEL_BLOCKS"]

#: The block widths the CUDA kernels serve.
KERNEL_BLOCKS = (32, 64, 128)
#: The largest C of the CUDA ``gather_mix_int8``: its dense (C, C) round
#: matrix and a 32-column tile of all C rows fit a block's shared memory
#: (``csrc/gather_mix_int8.cu:MAX_C``).
INT8_MAX_C = 224

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "quantize_block": [_ptr, _ll, _ptr, _ptr, _ptr, _ll, _int, _ll, _int, _int, _int, _ptr],
    "dequantize_block": [_ptr, _ptr, _ptr, _int, _ll, _int, _ll, _ll, _int, _ptr],
    "dequant_accumulate": [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _ll, _ll, _int, _int,
                           _int, _ptr],
    "gather_mix_int8": [_ptr, _ptr, _ptr, _ptr, _int, _ll, _int, _ll, _ll, _int, _ptr],
}


def _library(name: str):
    from .build import load
    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_int]
        err.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _library(name)
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, _sm_count(device.index),
                                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())


def _check_cuda(name: str, t: torch.Tensor, block: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"the CUDA {name} serves block {KERNEL_BLOCKS}, "
                         f"got {block}")


def _check_out(name: str, t: Optional[torch.Tensor], shape, dtype, device) -> None:
    if t is not None and (tuple(t.shape) != tuple(shape) or t.dtype != dtype
                          or t.device != device):
        raise ValueError(f"{name} must be a {tuple(shape)} {dtype} buffer on "
                         f"{device}; got {tuple(t.shape)} {t.dtype} on {t.device}")


def _row_strided(t: torch.Tensor) -> bool:
    """A (B, N) view whose rows are each contiguous."""
    return t.stride(1) == 1 or t.shape[1] == 1


def quantize_block(x: torch.Tensor, *, block: int = 128, levels: int = 127,
                   with_residual: bool = False, q_out: Optional[torch.Tensor] = None,
                   scales_out: Optional[torch.Tensor] = None,
                   residual_out: Optional[torch.Tensor] = None):
    """Encode x (B, N) f32 → ``(q, scales[, residual])``: q (B, NB·block)
    int8 in [-levels, levels], scales (B, NB) bf16, and with
    ``with_residual`` the error-feedback residual x − q·s_used (B, N) f32.

    ``q_out``, ``scales_out`` and ``residual_out`` are caller-given
    outputs (allocated when None).  ``residual_out`` may be ``x`` itself
    (each element is read before it is written); x and the residual may
    be row-strided views, q and the scales are contiguous.  Raises
    ``ValueError`` for an output of another shape, dtype or device, and,
    on the card, for x not f32, a block the kernel does not serve, or
    levels outside [1, 127]."""
    if x.dim() != 2:
        raise ValueError(f"quantize_block takes (B, N) rows, got {tuple(x.shape)}")
    if levels < 1:
        raise ValueError("levels must be >= 1")
    B, N = x.shape
    Np = padded_width(N, block)
    _check_out("q_out", q_out, (B, Np), torch.int8, x.device)
    _check_out("scales_out", scales_out, (B, Np // block), torch.bfloat16, x.device)
    if residual_out is not None:
        if not with_residual:
            raise ValueError("residual_out needs with_residual=True")
        _check_out("residual_out", residual_out, (B, N), torch.float32, x.device)
    if x.device.type == "cpu":
        res = quantize_block_ref(x, block, levels, with_residual)
        outs = (q_out, scales_out, residual_out)[:len(res)]
        return tuple(r if o is None else o.copy_(r) for r, o in zip(res, outs))
    _check_cuda("quantize_block", x, block)
    if x.dtype != torch.float32:
        raise ValueError(f"the CUDA quantize_block takes float32, got {x.dtype}")
    if levels > 127:
        raise ValueError(f"int8 holds levels up to 127, got {levels}")
    q = torch.empty((B, Np), dtype=torch.int8, device=x.device) if q_out is None else q_out
    s = (torch.empty((B, Np // block), dtype=torch.bfloat16, device=x.device)
         if scales_out is None else scales_out)
    r = None
    if with_residual:
        r = torch.empty((B, N), dtype=torch.float32, device=x.device) \
            if residual_out is None else residual_out
    if not (q.is_contiguous() and s.is_contiguous() and _row_strided(x)
            and (r is None or _row_strided(r))):
        raise ValueError("quantize_block needs row-contiguous x and residual, "
                         "contiguous q and scales")
    _launch("quantize_block", x.device, x.data_ptr(), x.stride(0), q.data_ptr(),
            s.data_ptr(), None if r is None else r.data_ptr(),
            0 if r is None else r.stride(0), B, N, block, levels)
    quantize_block.launches += 1
    return (q, s) if r is None else (q, s, r)


def dequantize_block(q: torch.Tensor, scales: torch.Tensor, *, block: int = 128,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode ``(q, scales)`` → (B, NB·block) f32, ``q·s`` per block, as
    the reference does, or write ``out``, a (B, n) f32 buffer with
    n ≤ NB·block, with the first n columns (as :func:`gather_mix_int8`
    does).  Raises ``ValueError`` for q and scales that do not agree with
    ``block`` or a bad ``out``, and, on the card, for a block the kernel
    does not serve or non-contiguous operands."""
    B, Nq = q.shape
    if Nq % block or tuple(scales.shape) != (B, Nq // block):
        raise ValueError(f"q {tuple(q.shape)} / scales {tuple(scales.shape)} do "
                         f"not agree with block {block}")
    n = Nq if out is None else out.shape[1]
    if not 1 <= n <= Nq:
        raise ValueError(f"out has {n} columns; the wire is {Nq} wide")
    _check_out("out", out, (B, n), torch.float32, q.device)
    if q.device.type == "cpu":
        res = dequantize_block_ref(q, scales, block)
        return res if out is None else out.copy_(res[:, :n])
    _check_cuda("dequantize_block", q, block)
    if q.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA dequantize_block takes int8 q and bf16 scales, "
                         f"got {q.dtype} and {scales.dtype}")
    if out is None:
        out = torch.empty((B, Nq), dtype=torch.float32, device=q.device)
    if not (q.is_contiguous() and scales.is_contiguous() and out.is_contiguous()):
        raise ValueError("dequantize_block needs contiguous q, scales and out")
    _launch("dequantize_block", q.device, q.data_ptr(), scales.data_ptr(),
            out.data_ptr(), B, Nq // block, block, n, n)
    dequantize_block.launches += 1
    return out


def dequant_accumulate(acc: Optional[torch.Tensor], q: torch.Tensor,
                       scales: torch.Tensor, w: torch.Tensor, *, block: int = 128,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8-block receive fold ``acc + w[:, None]·dequant(q, scales)``
    over (B, N) rows, in one pass: q (B, Nq) int8, scales (B, Nq / block)
    bf16, w (B,).  With ``acc`` (B, N), N ≤ Nq, f32 or bf16, the result
    has acc's width and dtype (the wire's block padding is dropped); with
    ``acc=None`` it is the init form ``w[:, None]·dequant(q, scales)``,
    (B, Nq) f32.

    ``out`` is a caller-given buffer of the result's shape, dtype and
    device (allocated when None); it may be ``acc``, so a receive folds
    in place and needs no (B, N) temporary.  Raises ``ValueError`` for q
    and scales that do not agree with ``block``, an acc wider than the
    wire, mixed devices or a bad ``out``, and, on the card, for a block
    the kernel does not serve, other dtypes, non-contiguous operands or
    B above 65535."""
    if q.dim() != 2:
        raise ValueError(f"dequant_accumulate takes (B, Nq) rows, got q of shape "
                         f"{tuple(q.shape)}")
    B, Nq = q.shape
    if Nq % block or tuple(scales.shape) != (B, Nq // block):
        raise ValueError(f"q {tuple(q.shape)} / scales {tuple(scales.shape)} do "
                         f"not agree with block {block}")
    if tuple(w.shape) != (B,):
        raise ValueError(f"w must be ({B},), got {tuple(w.shape)}")
    if acc is not None and (acc.dim() != 2 or acc.shape[0] != B):
        raise ValueError(f"acc must be ({B}, N), got {tuple(acc.shape)}")
    N = Nq if acc is None else acc.shape[1]
    if not 1 <= N <= Nq:
        raise ValueError(f"acc width {N} exceeds wire width {Nq}")
    for name, t in (("scales", scales), ("w", w), ("acc", acc)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    dtype = torch.float32 if acc is None else acc.dtype
    _check_out("out", out, (B, N), dtype, q.device)
    if q.device.type == "cpu":
        res = dequant_accumulate_ref(acc, q, scales, w, block)
        return res if out is None else out.copy_(res)
    _check_cuda("dequant_accumulate", q, block)
    if (q.dtype != torch.int8 or scales.dtype != torch.bfloat16
            or dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"the CUDA dequant_accumulate takes int8 q, bf16 scales and "
                         f"an f32 or bf16 acc, got {q.dtype}, {scales.dtype} and "
                         f"{'no acc' if acc is None else acc.dtype}")
    if B > 65535:
        raise ValueError(f"the CUDA dequant_accumulate takes up to 65535 rows, got {B}")
    if out is None:
        out = torch.empty((B, N), dtype=dtype, device=q.device)
    if not all(t.is_contiguous() for t in (q, scales, out)
               + (() if acc is None else (acc,))):
        raise ValueError("dequant_accumulate needs contiguous acc, q, scales and out")
    wf = w.to(torch.float32).contiguous()
    _launch("dequant_accumulate", q.device, None if acc is None else acc.data_ptr(),
            q.data_ptr(), scales.data_ptr(), wf.data_ptr(), out.data_ptr(), B, N, Nq,
            block, int(dtype == torch.bfloat16))
    dequant_accumulate.launches += 1
    return out


def gather_mix_int8(q: torch.Tensor, scales: torch.Tensor, srcs,
                    weights: torch.Tensor, *, block: int = 128,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One mixing round over the int8-block encoding of a (C, N)
    population: row i of the result is Σ_k weights[i, k] ·
    dequant(q, scales)[srcs[i, k]], f32, the (srcs, weights) table
    scattered into the dense round matrix by
    :func:`repro_torch.kernels.ref.round_matrix` (the matrix that
    ``gather_mix``'s register body builds in its own shared memory), at
    every C.

    Returns (C, NB·block) f32, as the reference does, or writes ``out``,
    a (C, n) f32 buffer with n ≤ NB·block, with the first n columns: a
    caller whose population is N wide passes a (C, N) ``out`` and never
    sees the block padding.  Raises ``ValueError`` for q and scales that
    do not agree with ``block``, a bad table (the reference's messages)
    or ``out``, and, on the card, for a block the kernel does not serve,
    non-contiguous operands, or C above :data:`INT8_MAX_C`."""
    C, Nq = q.shape
    if Nq % block or tuple(scales.shape) != (C, Nq // block):
        raise ValueError(f"q {tuple(q.shape)} / scales {tuple(scales.shape)} do "
                         f"not agree with block {block}")
    if weights.device != q.device:
        raise ValueError(f"weights lie on {weights.device}, q on {q.device}")
    n = Nq if out is None else out.shape[1]
    if not 1 <= n <= Nq:
        raise ValueError(f"out has {n} columns; the wire is {Nq} wide")
    _check_out("out", out, (C, n), torch.float32, q.device)
    W = round_matrix(C, srcs, weights)
    if q.device.type == "cpu":
        res = gather_mix_int8_ref(q, scales, srcs, weights, block)
        return res if out is None else out.copy_(res[:, :n])
    _check_cuda("gather_mix_int8", q, block)
    if q.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA gather_mix_int8 takes int8 q and bf16 scales, "
                         f"got {q.dtype} and {scales.dtype}")
    if C > INT8_MAX_C:
        raise ValueError(f"the CUDA gather_mix_int8 keeps the (C, C) round matrix "
                         f"in shared memory, so C <= {INT8_MAX_C}; got C={C}")
    if out is None:
        out = torch.empty((C, Nq), dtype=torch.float32, device=q.device)
    if not (q.is_contiguous() and scales.is_contiguous() and out.is_contiguous()):
        raise ValueError("gather_mix_int8 needs contiguous q, scales and out")
    _launch("gather_mix_int8", q.device, W.data_ptr(), q.data_ptr(), scales.data_ptr(),
            out.data_ptr(), C, Nq // block, block, n, n)
    gather_mix_int8.launches += 1
    return out


quantize_block.launches = 0
dequantize_block.launches = 0
dequant_accumulate.launches = 0
gather_mix_int8.launches = 0
