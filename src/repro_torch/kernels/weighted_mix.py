"""``weighted_mix``: Σ_k w_k·models[k] over K stacked flat model vectors.

The port of ``repro/kernels/weighted_mix.py:weighted_mix`` (a Pallas TPU
kernel), and every aggregation of the DFL engine
(:mod:`repro_torch.core.dfl`): a gossip wake-up over the own model and
the received ones, FedAvg's weighted global average, Gaia's region and
inter-region means, DFL-DDS's neighbourhood mean.

``weights`` may lie on the host or on the models' device, and ``mask``
(K,) beside them.  With a mask, masked-out models are dropped and the
surviving weights renormalized, ``w·m / Σ(w·m)``; if every model is
masked the result is zeros.  That renormalization is K scalar operations
on the weights' device outside the kernel
(:func:`repro_torch.kernels.ref.masked_weights`), as in the reference,
with no read back to the host.  The DFL engine passes host weights: they
travel in the launch's parameters (up to :data:`MAX_BY_VALUE` of them),
so a call copies nothing to the device and waits for nothing.

On a CUDA tensor this launches ``csrc/weighted_mix.cu`` (its header says
what bounds it and how it streams) with the plan of :func:`launch_plan`,
and raises if the build or the launch fails; on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.weighted_mix_ref`,
which sums in the kernel's order and rounding, so the two agree bit for
bit.

``models`` may be any (K, N) view whose columns are adjacent: its rows
are read through their stride, so a view into a larger buffer needs no
copy.  ``out`` is a caller-given (N,) buffer of the models' dtype and
device (allocated when None); it may be one of the rows of ``models``.

``weighted_mix.launches`` counts kernel launches; the plain path does not
count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .gather_mix import _sm_count
from .ref import masked_weights, weighted_mix_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: host weights travel in the launch's parameters up to this K (2 KB of
#: the 4 KB a launch takes; ``csrc/weighted_mix.cu:MAX_BY_VALUE``); more
#: are copied to the device and read through a pointer
MAX_BY_VALUE = 512
#: block sizes, largest first; the kernel's ``MAX_THREADS`` is the first
BLOCK_SIZES = (256, 128, 64, 32)
#: threads an SM that the grid-stride loop keeps at most: 16 blocks of 256
THREADS_PER_SM = 4096


class LaunchPlan(NamedTuple):
    """How one ``weighted_mix`` call launches: ``vec`` elements a load,
    ``threads`` a block, ``blocks`` in the grid, and the weights in the
    launch's parameters (``by_value``) or read through a pointer."""
    vec: int
    threads: int
    blocks: int
    by_value: bool


def launch_plan(K: int, N: int, itemsize: int, row_stride: int, base: int, out: int,
                sms: int, host_weights: bool) -> LaunchPlan:
    """The launch of K rows of N elements of ``itemsize`` bytes, rows
    ``row_stride`` elements apart from address ``base``, into ``out``, on
    a card of ``sms`` SMs.

    The load is the widest of 16, 8 and 4 bytes (and 2 for bf16) that the
    base, the output and, with K > 1, the row stride are all aligned to.
    The block is the largest of :data:`BLOCK_SIZES` that still gives a
    block to every SM (the smallest when none does), and the grid one
    thread a load of a row, at most :data:`THREADS_PER_SM` threads an SM,
    beyond which a thread walks N in a grid-stride loop.  K sets no block
    count: a thread sums its elements over k in order, so K cannot be
    split across threads.  Host weights go by value up to
    :data:`MAX_BY_VALUE`."""
    align = base | out | (row_stride * itemsize if K > 1 else 0)
    width = min(16, align & -align) if align else 16
    vec = width // itemsize or 1
    loads = -(-N // vec)
    for threads in BLOCK_SIZES:
        if loads > (sms - 1) * threads:       # ceil(loads / threads) >= sms
            break
    blocks = min(-(-loads // threads), sms * THREADS_PER_SM // threads)
    return LaunchPlan(vec, threads, max(1, blocks), host_weights and K <= MAX_BY_VALUE)


def _library():
    from .build import load
    lib = load("weighted_mix")
    if lib.weighted_mix.argtypes is None:
        lib.weighted_mix.argtypes = [_ptr, _ll, _ptr, _int, _ptr, _int, _ll, _int, _int,
                                     _int, _int, _ptr]
        lib.weighted_mix.restype = _int
        lib.weighted_mix_error_string.argtypes = [_int]
        lib.weighted_mix_error_string.restype = ctypes.c_char_p
    return lib


def weighted_mix(models: torch.Tensor, weights: torch.Tensor, *,
                 mask: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """models (K, N), weights (K,) float on the host or the models'
    device, mask (K,) or None beside the weights → ``out`` (N,) holding
    Σ_k w_k·models[k] in ``models.dtype``, f32 math.

    Raises ``ValueError`` for shapes that do not agree, weights on a
    device other than the host or the models', a mask on a device other
    than the weights', an ``out`` of another shape, dtype or device or
    not contiguous, and, on the card, for K = 0, a dtype other than
    float32 / bfloat16 or models whose columns are not adjacent
    (ROADMAP.md, Queue 3)."""
    if models.dim() != 2:
        raise ValueError(f"weighted_mix takes (K, N) models, got shape "
                         f"{tuple(models.shape)}")
    K, N = models.shape
    if tuple(weights.shape) != (K,):
        raise ValueError(f"weights must be ({K},), got {tuple(weights.shape)}")
    if mask is not None and tuple(mask.shape) != (K,):
        raise ValueError(f"mask must be ({K},), got {tuple(mask.shape)}")
    if weights.device.type != "cpu" and weights.device != models.device:
        raise ValueError(f"weights on {weights.device}, models on {models.device}")
    if mask is not None and mask.device != weights.device:
        raise ValueError(f"mask on {mask.device}, weights on {weights.device}")
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
    w = masked_weights(weights, mask)
    dev = models.device
    base, row_stride, out_ptr = models.data_ptr(), models.stride(0), out.data_ptr()
    plan = launch_plan(K, N, models.element_size(), row_stride, base, out_ptr,
                       _sm_count(dev.index), not w.is_cuda)
    w = w.contiguous() if plan.by_value else w.to(dev).contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.weighted_mix(base, row_stride, w.data_ptr(), int(plan.by_value), out_ptr,
                               K, N, int(models.dtype == torch.bfloat16), plan.vec,
                               plan.threads, plan.blocks,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("weighted_mix launch failed: "
                           + lib.weighted_mix_error_string(err).decode())
    weighted_mix.launches += 1
    return out


weighted_mix.launches = 0
