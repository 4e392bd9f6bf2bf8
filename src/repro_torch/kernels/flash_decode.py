"""``flash_decode``: single-token GQA attention against a KV cache.

The port of ``repro/kernels/flash_decode.py:flash_decode`` (a Pallas TPU
kernel).  On a CUDA tensor this launches the hand-written kernel in
``csrc/flash_decode.cu`` (its header says what bounds it and how it is
laid out); if the build or the launch fails it raises.  On a CPU tensor
it runs the plain version, :func:`repro_torch.kernels.ref.flash_decode_ref`.

Semantics are those of ``flash_decode_ref``: entry ``idx`` of row ``b``
is valid when ``idx <= pos[b]`` and ``idx < L``; rows with ``pos < 0``
are empty serving slots and come back exactly zero.  (The TPU kernel
pads L with zero keys and masks only ``idx <= pos``, so for ``pos >= L``
with L not a block multiple it lets the padding into the softmax; the
serving loop never passes such a position, and the port does not copy
that.)

``flash_decode.launches`` counts kernel launches; the plain path does
not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import flash_decode_ref

MIN_CHUNK = 64             # fewest cache rows one L split covers
MAX_CHUNK = 512            # most cache rows one L split covers
HEAD_DIMS = (32, 64, 128)  # the head_dims of the served configs
MAX_GROUP = 16             # query heads per KV head, kept in registers
_DTYPES = (torch.float32, torch.bfloat16)

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    from .build import load
    lib = load("flash_decode")
    if lib.flash_decode.argtypes is None:
        lib.flash_decode.argtypes = (
            [_ptr] * 8 + [_int] * 7 + [ctypes.c_float] + [_ll] * 6
            + [_int, _int, _ptr])
        lib.flash_decode.restype = _int
        lib.flash_decode_error_string.argtypes = [_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _splits(B: int, Hkv: int, L: int, sms: int):
    """(n_split, chunk): L is cut into n_split spans of ``chunk`` rows,
    at most MAX_CHUNK long, and shorter (down to MIN_CHUNK) when
    B * Hkv * n_split blocks would leave SMs idle."""
    n_split = max(-(-4 * sms // (B * Hkv)), -(-L // MAX_CHUNK))
    n_split = max(1, min(n_split, -(-L // MIN_CHUNK)))
    chunk = -(-L // n_split)
    return -(-L // chunk), chunk


def _check_shapes(q, k_cache, v_cache):
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"flash_decode takes q (B, Hq, hd) and caches (B, L, Hkv, hd) of "
            f"one shape; got q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}")
    B, Hq, hd = q.shape
    _, L, Hkv, khd = k_cache.shape
    if k_cache.shape[0] != B or khd != hd or L < 1:
        raise ValueError(
            f"cache shape {tuple(k_cache.shape)} does not fit q "
            f"{tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(
            f"flash_decode requires Hq to be an integer multiple of Hkv "
            f"(GQA query groups); got Hq={Hq}, Hkv={Hkv}")


def _pos_vector(pos, B: int, device: torch.device) -> torch.Tensor:
    """Scalar or (B,) ``pos`` as a contiguous (B,) int32 tensor."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.as_tensor(pos)
        if pos.dim() == 0:
            return torch.full((B,), int(pos), dtype=torch.int32, device=device)
        pos = pos.to(device)
    if pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != B):
        raise ValueError(
            f"pos must be a scalar or a ({B},) per-slot vector, got shape "
            f"{tuple(pos.shape)}")
    if pos.device != device:
        raise ValueError(f"pos lies on {pos.device}, q on {device}")
    if pos.dtype.is_floating_point or pos.dtype == torch.bool:
        raise ValueError(f"pos must be an integer tensor, got {pos.dtype}")
    return pos.reshape(-1).expand(B).to(torch.int32).contiguous()


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos) -> torch.Tensor:
    """q (B, Hq, hd) against caches (B, L, Hkv, hd); ``pos`` a scalar or
    a (B,) per-slot vector.  Returns (B, Hq, hd) in q's dtype.

    Raises ``ValueError`` when Hq is not a multiple of Hkv, when ``pos``
    is neither a scalar nor (B,), for mixed devices, and, on the card,
    for a dtype other than float32 / bfloat16, a non-contiguous q, a
    cache whose last axis is strided or whose rows do not start on the
    kernel's load width, or a head_dim / group width the kernel was not
    built for (see ``HEAD_DIMS``)."""
    _check_shapes(q, k_cache, v_cache)
    B, Hq, hd = q.shape
    devices = {q.device, k_cache.device, v_cache.device}
    if len(devices) != 1:
        raise ValueError(f"q and the caches lie on different devices: "
                         f"{sorted(map(str, devices))}")
    pos_vec = _pos_vector(pos, B, q.device)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, pos_vec)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError(
            f"flash_decode takes float32 or bfloat16 q and one such dtype "
            f"for both caches; got q {q.dtype}, k {k_cache.dtype}, "
            f"v {v_cache.dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_decode needs a contiguous q")
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("flash_decode needs caches with unit stride on "
                         "the head_dim axis")

    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(
            f"the CUDA flash_decode takes head_dim in {HEAD_DIMS} and at "
            f"most {MAX_GROUP} query heads per KV head, so that a group's "
            f"accumulators stay in registers; got head_dim={hd}, G={G}")
    # each lane loads hd / 32 elements of a row in words of up to 16 bytes
    align = min(hd // 32 * k_cache.element_size(), 16)
    for t in (k_cache, v_cache):
        if t.data_ptr() % align or any(st * t.element_size() % align
                                       for st in t.stride()[:3]):
            raise ValueError(f"flash_decode needs cache rows that start on "
                             f"{align}-byte boundaries")
    lib = _library()
    n_split, chunk = _splits(B, Hkv, L, _sm_count(q.device.index))

    out = torch.empty_like(q)
    m_part = l_part = acc_part = None
    if n_split > 1:
        m_part = torch.empty((B * Hq * n_split,), dtype=torch.float32,
                             device=q.device)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((B * Hq * n_split * hd,), dtype=torch.float32,
                               device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos_vec.data_ptr(), out.data_ptr(), ptr(m_part), ptr(l_part),
            ptr(acc_part), B, Hq, Hkv, hd, L, n_split, chunk, hd ** -0.5,
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_decode launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
