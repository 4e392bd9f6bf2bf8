"""``weighted_mix``: Σ_k w_k·models[k] over K stacked flat model vectors.

The port of ``repro/kernels/weighted_mix.py:weighted_mix`` (a Pallas TPU
kernel), and every aggregation of the DFL engine
(:mod:`repro_torch.core.dfl`): a gossip wake-up over the own model and
the received ones, FedAvg's weighted global average, Gaia's region and
inter-region means, DFL-DDS's neighbourhood mean.

With ``mask`` (K,), masked-out models are dropped and the surviving
weights renormalized, ``w·m / Σ(w·m)``; if every model is masked the
result is zeros.  That renormalization is K scalar operations on the
device outside the kernel (:func:`repro_torch.kernels.ref.masked_weights`),
as in the reference, with no read back to the host.

On a CUDA tensor this launches ``csrc/weighted_mix.cu`` (its header says
what bounds it and how it streams), and raises if the build or the
launch fails; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.weighted_mix_ref`, which sums in the
kernel's order and rounding, so the two agree bit for bit.

``models`` may be any (K, N) view whose columns are adjacent: its rows
are read through their stride, so a view into a larger buffer needs no
copy.  ``out`` is a caller-given (N,) buffer of the models' dtype and
device (allocated when None); it may be one of the rows of ``models``.

``weighted_mix.launches`` counts kernel launches; the plain path does not
count.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .gather_mix import _sm_count
from .ref import masked_weights, weighted_mix_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    from .build import load
    lib = load("weighted_mix")
    if lib.weighted_mix.argtypes is None:
        lib.weighted_mix.argtypes = [_ptr, _ll, _ptr, _ptr, _int, _ll, _int, _int, _ptr]
        lib.weighted_mix.restype = _int
        lib.weighted_mix_error_string.argtypes = [_int]
        lib.weighted_mix_error_string.restype = ctypes.c_char_p
    return lib


def weighted_mix(models: torch.Tensor, weights: torch.Tensor, *,
                 mask: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """models (K, N), weights (K,) float, mask (K,) or None → ``out`` (N,)
    holding Σ_k w_k·models[k] in ``models.dtype``, f32 math.

    Raises ``ValueError`` for shapes that do not agree, mixed devices, an
    ``out`` of another shape, dtype or device or not contiguous, and, on
    the card, for K = 0, a dtype other than float32 / bfloat16 or models
    whose columns are not adjacent (ROADMAP.md, Queue 3)."""
    if models.dim() != 2:
        raise ValueError(f"weighted_mix takes (K, N) models, got shape "
                         f"{tuple(models.shape)}")
    K, N = models.shape
    if tuple(weights.shape) != (K,):
        raise ValueError(f"weights must be ({K},), got {tuple(weights.shape)}")
    if mask is not None and tuple(mask.shape) != (K,):
        raise ValueError(f"mask must be ({K},), got {tuple(mask.shape)}")
    for name, t in (("weights", weights), ("mask", mask)):
        if t is not None and t.device != models.device:
            raise ValueError(f"{name} on {t.device}, models on {models.device}")
    if out is not None and (tuple(out.shape) != (N,) or out.dtype != models.dtype
                            or out.device != models.device or out.stride(0) != 1):
        raise ValueError(
            f"out must be a contiguous ({N},) {models.dtype} buffer on "
            f"{models.device}; got {tuple(out.shape)} {out.dtype} on {out.device}")
    if models.device.type == "cpu":
        res = weighted_mix_ref(models, weights, mask)
        return res if out is None else out.copy_(res)
    if models.device.type != "cuda":
        raise ValueError(f"weighted_mix runs on cuda or cpu, not {models.device}")
    if K == 0:
        raise ValueError("the CUDA weighted_mix needs at least one model (K >= 1)")
    if models.dtype not in _DTYPES:
        raise ValueError(f"the CUDA weighted_mix takes float32 or bfloat16 models, "
                         f"got {models.dtype}")
    if N > 1 and models.stride(1) != 1:
        raise ValueError(f"the CUDA weighted_mix needs adjacent columns; models has "
                         f"strides {tuple(models.stride())}")
    if out is None:
        out = torch.empty(N, dtype=models.dtype, device=models.device)
    w = masked_weights(weights, mask).contiguous()
    lib = _library()
    with torch.cuda.device(models.device):
        err = lib.weighted_mix(models.data_ptr(), models.stride(0), w.data_ptr(),
                               out.data_ptr(), K, N, int(models.dtype == torch.bfloat16),
                               _sm_count(models.device.index),
                               torch.cuda.current_stream(models.device).cuda_stream)
    if err != 0:
        raise RuntimeError("weighted_mix launch failed: "
                           + lib.weighted_mix_error_string(err).decode())
    weighted_mix.launches += 1
    return out


weighted_mix.launches = 0
