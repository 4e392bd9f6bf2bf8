"""``gather_mix``: one whole mixing round over a resident (C, N) buffer.

The port of ``repro/kernels/weighted_mix.py:gather_mix`` (a Pallas TPU
kernel).  Row i of the result is Σ_k weights[i, k] · buf[srcs[i, k]]:
the (srcs, weights) table is scattered into the dense (C, C) round
matrix W by :func:`repro_torch.kernels.ref.round_matrix` outside the
kernel, and the kernel computes W · buf column by column, reading every
byte of ``buf`` once and writing every output byte once
(``csrc/gather_mix.cu``; its header says what bounds it).  On a CUDA
tensor this launches that kernel, and raises if the build or the launch
fails; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.gather_mix_ref`.

``out`` is a caller-given (C, N) buffer of ``buf``'s dtype and device
(allocated when None).  It may be ``buf`` itself: every column of the
result depends on that column of ``buf`` alone, and the kernel reads a
column before it writes it, so the round can run in place.

``gather_mix.launches`` counts kernel launches; the plain path does not
count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .ref import gather_mix_ref, round_matrix

MAX_C = 224    # W (C x C f32) and a 32-column tile fit a block's shared memory
_DTYPES = (torch.float32, torch.bfloat16)

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    from .build import load
    lib = load("gather_mix")
    if lib.gather_mix.argtypes is None:
        lib.gather_mix.argtypes = [_ptr, _ptr, _ptr, _int, _ll, _int, _int, _ptr]
        lib.gather_mix.restype = _int
        lib.gather_mix_error_string.argtypes = [_int]
        lib.gather_mix_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gather_mix(buf: torch.Tensor, srcs, weights: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf (C, N); srcs (C, K1) int source rows (numpy, checked for range,
    or a tensor); weights (C, K1) float.  Returns ``out`` (C, N) in
    ``buf.dtype`` holding Σ_k weights[i, k] · buf[srcs[i, k]], with f32
    accumulation.

    Raises ``ValueError`` for out-of-range host sources or a table that
    does not match C (the reference's messages), for mixed devices or an
    ``out`` of another shape or dtype, and, on the card, for a dtype other
    than float32 / bfloat16, a non-contiguous ``buf`` or ``out``, or C
    above ``MAX_C``."""
    if buf.dim() != 2:
        raise ValueError(f"gather_mix takes a (C, N) buffer, got shape "
                         f"{tuple(buf.shape)}")
    C, N = buf.shape
    if weights.device != buf.device:
        raise ValueError(f"weights lie on {weights.device}, buf on {buf.device}")
    if out is not None and (out.shape != buf.shape or out.dtype != buf.dtype
                            or out.device != buf.device):
        raise ValueError(
            f"out must be a {tuple(buf.shape)} {buf.dtype} buffer on "
            f"{buf.device}; got {tuple(out.shape)} {out.dtype} on {out.device}")
    W = round_matrix(C, srcs, weights)
    if buf.device.type == "cpu":
        res = gather_mix_ref(buf, srcs, weights)
        return res if out is None else out.copy_(res)
    if buf.device.type != "cuda":
        raise ValueError(f"gather_mix runs on cuda or cpu, not {buf.device}")
    if buf.dtype not in _DTYPES:
        raise ValueError(f"the CUDA gather_mix takes float32 or bfloat16, "
                         f"got {buf.dtype}")
    if C > MAX_C:
        raise ValueError(f"the CUDA gather_mix keeps the (C, C) round matrix "
                         f"in shared memory, so C <= {MAX_C}; got C={C}")
    if out is None:
        out = torch.empty_like(buf)
    if not (buf.is_contiguous() and out.is_contiguous()):
        raise ValueError("gather_mix needs contiguous buf and out")
    lib = _library()
    with torch.cuda.device(buf.device):
        err = lib.gather_mix(W.data_ptr(), buf.data_ptr(), out.data_ptr(), C, N,
                             int(buf.dtype == torch.bfloat16),
                             _sm_count(buf.device.index),
                             torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError("gather_mix launch failed: "
                           + lib.gather_mix_error_string(err).decode())
    gather_mix.launches += 1
    return out


gather_mix.launches = 0
