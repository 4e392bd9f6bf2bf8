"""``flash_decode``: single-token GQA attention against a KV cache.

The port of ``repro/kernels/flash_decode.py:flash_decode`` (a Pallas TPU
kernel).  On a CUDA tensor this launches the hand-written kernel in
``csrc/flash_decode.cu``, one launch a call; if the build or the launch
fails it raises.  On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.flash_decode_ref`.

The kernel is bound by the bytes of the valid cache prefix.  Its grid
(:func:`grid_blocks`) is two or four blocks an SM (:func:`blocks_per_sm`),
sized from the shapes alone; each block reads ``pos`` on the device and
takes a span of one (b, KV head)'s valid rows, so empty slots get no
block, long rows get proportionally more, and the KV heads of a span are
neighbouring blocks (:func:`partition` mirrors the kernel's formula for
the CPU tests).  A block streams its span through a ring of at least
three 32-row K/V tiles in shared memory by 16-byte ``cp.async``, the next
tiles' copies issued before the current one is scored: 128 KB in flight
an SM at head_dim 128, f32 or bf16.  Spans of one (b, KV head) leave
(m, l, acc) partials in a scratch buffer; the block that draws the last
ticket of a counter merges them in span order, so the result is the
same bits on every call.  The scratch and the counters are allocated
once per device and stream (:func:`_scratch`) and the counters go back
to 0 inside the kernel, so a call allocates only its output.

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

TILE_ROWS = 32             # cache rows a tile of the kernel's shared-memory ring
HEAD_DIMS = (32, 64, 128)  # the head_dims of the served configs
MAX_GROUP = 16             # query heads per KV head, kept in registers
_DTYPES = (torch.float32, torch.bfloat16)

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    from .build import load
    lib = load("flash_decode")
    if lib.flash_decode.argtypes is None:
        lib.flash_decode.argtypes = (
            [_ptr] * 7 + [_int] * 7 + [ctypes.c_float] + [_ll] * 6
            + [_int, _int, _ptr])
        lib.flash_decode.restype = _int
        lib.flash_decode_error_string.argtypes = [_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def blocks_per_sm(kv_bytes: int, G: int) -> int:
    """Blocks of the kernel that share an SM: four for a bf16 cache and a
    group of at most 4 query heads, else two (csrc/flash_decode.cu)."""
    return 4 if kv_bytes == 2 and G <= 4 else 2


def grid_blocks(B: int, Hkv: int, L: int, sms: int, per_sm: int) -> int:
    """The kernel's grid: about ``per_sm`` blocks an SM, a multiple of
    Hkv, at least one a (b, KV head) and at most one a cache entry.  It
    depends on the shapes alone, never on ``pos``, so the host never
    waits on the device."""
    return Hkv * min(max(B, -(-per_sm * sms // Hkv)), B * L)


def partition(pos, Hkv: int, L: int, n_blocks: int) -> list:
    """What each block of the kernel works on, as the kernel computes it
    on the device (``csrc/flash_decode.cu:find_span``; the formula is in
    both headers): entry ``i`` is ``None`` for a block with no span, else
    ``(b, h, r0, r1, first, count)``: cache entries [r0, r1) of KV head h
    of row b, whose ``count`` spans sit in the blocks (and partial slots)
    ``first + j * Hkv``, j = 0 .. count - 1, in span order.

    With n_b = min(pos_b + 1, L) (0 for pos_b < 0) the valid entries of
    row b, T = sum(n_b), U the live rows, S = n_blocks / Hkv,
    N = min(S, T), E = N - U and D = T - U, block i takes KV head
    h = i % Hkv and span index q = i / Hkv < N; live row b owns the span
    indices [C(b), C(b + 1)) with C(b) = (live rows before b) +
    floor(E * R(b) / D) (0 when D = 0), R(b) the sum of n - 1 over the
    live rows before b; span j of the c spans of a row of n entries holds
    entries [floor(j * n / c), floor((j + 1) * n / c))."""
    n = [0 if p < 0 else min(p + 1, L) for p in (int(x) for x in pos)]
    T = sum(n)
    U = sum(1 for x in n if x > 0)
    N = min(n_blocks // Hkv, T)
    E, D = N - U, T - U

    def C(live_before, r):
        return live_before + (E * r // D if D > 0 else 0)

    spans = [None] * n_blocks
    live_before = r = 0
    for b, nb in enumerate(n):
        if nb == 0:
            continue
        c0, c1 = C(live_before, r), C(live_before + 1, r + nb - 1)
        c = c1 - c0
        for j in range(c):
            for h in range(Hkv):
                spans[(c0 + j) * Hkv + h] = (b, h, j * nb // c,
                                             (j + 1) * nb // c, c0 * Hkv + h, c)
        live_before, r = live_before + 1, r + nb - 1
    return spans


def scratch_sizes(B: int, Hq: int, Hkv: int, hd: int, n_blocks: int):
    """(floats, ints) of the kernel's scratch: a span's partial (acc of G
    heads, then their m and l, padded to 16 bytes) in the slot of its
    block, and one ticket counter a (b, KV head)."""
    G = Hq // Hkv
    return n_blocks * -(-G * (hd + 2) // 4) * 4, B * Hkv


#: (device index, stream) -> (partials, tickets).  A stream's calls run in
#: order, so they share one scratch; the tickets are 0 between calls (the
#: last ticket of a call wraps each counter back to 0), so they are zeroed
#: once, when made.
_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, floats: int, ints: int):
    key = (device.index, stream)
    part, ticket = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty((floats,), dtype=torch.float32, device=device)
    if ticket is None or ticket.numel() < ints:
        ticket = torch.zeros((ints,), dtype=torch.int32, device=device)
    _SCRATCH[key] = part, ticket
    return part, ticket


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
    if (pos.dtype == torch.int32 and pos.dim() == 1 and pos.shape[0] == B
            and pos.device == device and pos.is_contiguous()):
        return pos                      # the serving loop's own vector
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
    # the cache rows start on at least min(hd / 32 elements, 16 bytes); the
    # kernel copies them to shared memory in the widest words they allow:
    # the lowest set bit of every row start's offsets, at most 16
    size = k_cache.element_size()
    sk, sv = k_cache.stride()[:3], v_cache.stride()[:3]
    offsets = k_cache.data_ptr() | v_cache.data_ptr() | 16
    for st in sk + sv:
        offsets |= st * size
    copy_bytes = offsets & -offsets
    align = min(hd // 32 * size, 16)
    if copy_bytes < align:
        raise ValueError(f"flash_decode needs cache rows that start on "
                         f"{align}-byte boundaries")
    lib = _library()
    n_blocks = grid_blocks(B, Hkv, L, _sm_count(q.device.index),
                           blocks_per_sm(size, G))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, ticket = _scratch(q.device, stream,
                            *scratch_sizes(B, Hq, Hkv, hd, n_blocks))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos_vec.data_ptr(), out.data_ptr(), part.data_ptr(),
            ticket.data_ptr(), B, Hq, Hkv, hd, L, n_blocks, copy_bytes,
            hd ** -0.5, *sk, *sv,
            int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("flash_decode launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
