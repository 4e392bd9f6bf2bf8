"""``mix_accumulate``: the incremental mixing accumulate over (B, N) rows.

The port of ``repro/kernels/weighted_mix.py:mix_accumulate`` (a Pallas
TPU kernel).  With per-row weights w (B,):

* ``mix_accumulate(acc, x, w)`` is ``acc + w[:, None]·x`` in f32 math,
  cast to ``acc.dtype``;
* ``mix_accumulate(None, x, w)`` is the init form ``w[:, None]·x``, cast
  to ``x.dtype`` (the self term of a mixing round).

On a CUDA tensor this launches ``csrc/mix_accumulate.cu`` (its header
says what bounds it, and why the accumulate form is one fused
multiply-add), and raises if the build or the launch fails; on a CPU
tensor it runs the plain version,
:func:`repro_torch.kernels.ref.mix_accumulate_ref`.

``out`` is a caller-given buffer of the result's shape, dtype and device
(allocated when None).  It may be ``acc`` or ``x``: every element of the
result depends on the same element of the inputs alone.

``mix_accumulate.launches`` counts kernel launches; the plain path does
not count.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .gather_mix import _sm_count
from .ref import mix_accumulate_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    from .build import load
    lib = load("mix_accumulate")
    if lib.mix_accumulate.argtypes is None:
        lib.mix_accumulate.argtypes = [_ptr, _ptr, _ptr, _ptr, _int, _ll, _int, _int,
                                       _int, _ptr]
        lib.mix_accumulate.restype = _int
        lib.mix_accumulate_error_string.argtypes = [_int]
        lib.mix_accumulate_error_string.restype = ctypes.c_char_p
    return lib


def mix_accumulate(acc: Optional[torch.Tensor], x: torch.Tensor, w: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc (B, N) or None, x (B, N), w (B,) float → ``out`` holding
    ``acc + w[:, None]·x`` in ``acc.dtype`` (``w[:, None]·x`` in
    ``x.dtype`` when acc is None), f32 math.

    Raises ``ValueError`` for shapes that do not agree, mixed devices, an
    ``out`` of another shape, dtype or device, and, on the card, for a
    dtype other than float32 / bfloat16 or a non-contiguous operand."""
    if x.dim() != 2:
        raise ValueError(f"mix_accumulate takes (B, N) rows, got x of shape "
                         f"{tuple(x.shape)}")
    B, N = x.shape
    if tuple(w.shape) != (B,):
        raise ValueError(f"w must be ({B},), got {tuple(w.shape)}")
    if acc is not None and acc.shape != x.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and x {tuple(x.shape)} differ")
    like = x if acc is None else acc
    for name, t in (("w", w), ("acc", acc)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if out is not None and (out.shape != x.shape or out.dtype != like.dtype
                            or out.device != x.device):
        raise ValueError(
            f"out must be a {tuple(x.shape)} {like.dtype} buffer on {x.device}; "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if x.device.type == "cpu":
        res = mix_accumulate_ref(acc, x, w)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"mix_accumulate runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES or like.dtype not in _DTYPES:
        raise ValueError(f"the CUDA mix_accumulate takes float32 or bfloat16, got "
                         f"x {x.dtype}" + ("" if acc is None else f", acc {acc.dtype}"))
    if out is None:
        out = torch.empty_like(like)
    if not all(t.is_contiguous() for t in (x, out) + (() if acc is None else (acc,))):
        raise ValueError("mix_accumulate needs contiguous acc, x and out")
    wf = w.to(torch.float32).contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mix_accumulate(
            None if acc is None else acc.data_ptr(), x.data_ptr(), wf.data_ptr(),
            out.data_ptr(), B, N, int(like.dtype == torch.bfloat16),
            int(x.dtype == torch.bfloat16), _sm_count(x.device.index),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("mix_accumulate launch failed: "
                           + lib.mix_accumulate_error_string(err).decode())
    mix_accumulate.launches += 1
    return out


mix_accumulate.launches = 0
