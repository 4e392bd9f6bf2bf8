"""``gather_mix``: one whole mixing round over a resident (C, N) buffer.

The port of ``repro/kernels/weighted_mix.py:gather_mix`` (a Pallas TPU
kernel).  Row i of the result is Σ_k weights[i, k] · buf[srcs[i, k]],
reading every byte of ``buf`` once and writing every output byte once
(``csrc/gather_mix.cu``; its header says what bounds it).  The body
follows from C (:func:`launch_plan`): up to :data:`REGISTER_MAX_C` rows
the register body scatters the (srcs, weights) table into the dense
(C, C) round matrix W in shared memory and computes W · buf column by
column; above it the gather body reads each row's K1 sources from the
table itself, over column tiles staged in shared memory.  Either way
the call is one launch, and no W is built outside it.  On a CUDA tensor
this launches that kernel, and raises if the build or the launch fails;
on a CPU tensor it runs the plain version,
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
from typing import NamedTuple, Optional

import torch

from .ref import gather_mix_ref, gather_table

#: the most rows the register body holds (its rows live in registers)
REGISTER_ROWS = 32
#: the plan takes the register body up to this C and the gather body
#: above: timed both on the card, the register body is the faster up to
#: C 24 at every N tried, the gather body from C 28 (PERF.md §6, PR 29)
REGISTER_MAX_C = 24
#: the shared memory one block may use on Hopper
SMEM_BYTES = 232_448
#: the gather body's narrowest tile, in columns
MIN_TILE = 32
#: the largest C of the gather body: one stage of a MIN_TILE-column f32
#: tile of all C rows fills a block's shared memory
GATHER_MAX_C = SMEM_BYTES // (MIN_TILE * 4)
#: the gather body's tiles, widest first
GATHER_TILES = (128, 64, 32)
#: an SM's shared memory, and what the card reserves of it for each block
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1024
#: threads a block of the register body and of the gather body, and an SM's
THREADS, GATHER_THREADS, SM_THREADS = 256, 512, 2048
#: the gather body's blocks an SM: its ``__launch_bounds__`` hold it to the
#: 64 registers a thread that two blocks of GATHER_THREADS leave, and it
#: takes more than the 40 that three would (so the grid counts on two)
GATHER_MIN_BLOCKS = 2
_DTYPES = (torch.float32, torch.bfloat16)

_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class LaunchPlan(NamedTuple):
    """How one ``gather_mix`` call launches.  ``body`` "register" or
    "gather"; ``tile`` columns a gather stage holds and ``stages`` of them
    in its ring (0 for the register body); ``table``: the gather body
    copies the (C, K1) table into shared memory beside the ring (else it
    reads it from device memory); ``width`` bytes a thread moves in one
    load, copy or store; ``smem`` dynamic shared-memory bytes a block;
    ``threads`` a block and ``blocks`` in the grid."""
    body: str
    tile: int
    stages: int
    table: bool
    width: int
    smem: int
    threads: int
    blocks: int


def _widest(align: int) -> int:
    """The widest of 16, 8, 4, 2, 1 bytes that ``align`` is a multiple of."""
    return min(16, align & -align) if align else 16


def register_plan(C: int, N: int, itemsize: int, buf: int, out: int, sms: int) -> LaunchPlan:
    """The register body for C ≤ :data:`REGISTER_ROWS` rows of N
    elements of ``itemsize`` bytes, from address ``buf`` into ``out``, on
    a card of ``sms`` SMs: VEC elements a load, 4 for C ≤ 16 and 2 above,
    or 1 where ``buf``, ``out`` or the row length is not aligned to
    VEC elements; one thread a load of a column group, at most 8 blocks
    an SM."""
    if not 1 <= C <= REGISTER_ROWS:
        raise ValueError(f"the register body takes 1 <= C <= {REGISTER_ROWS}; got C={C}")
    vec = 4 if C <= 16 else 2
    if _widest(buf | out | N * itemsize) < vec * itemsize:
        vec = 1
    need = -(-(N // vec) // THREADS)
    return LaunchPlan("register", 0, 0, False, vec * itemsize, C * C * 4, THREADS,
                      max(1, min(need, SM_THREADS // THREADS * sms)))


def gather_plan(C: int, K1: int, N: int, itemsize: int, buf: int, out: int,
                sms: int) -> LaunchPlan:
    """The gather body for C ≤ :data:`GATHER_MAX_C` rows of K1 sources
    (the other arguments as :func:`register_plan`).  The copy and store
    width is the widest of 16, 8 and 4 bytes (and 2 for bf16) that
    ``buf``, ``out`` and the row length N·itemsize are all aligned to.
    The tile is the widest of :data:`GATHER_TILES` whose two stages and
    the (C, K1) table leave room for :data:`GATHER_MIN_BLOCKS` blocks an
    SM; else 32 columns in two stages where they fit a block, else in
    one.  The table (8 bytes an entry) is kept in shared memory where it
    fits beside the ring, and read from device memory otherwise, so the
    limit does not depend on K1.  Blocks of :data:`GATHER_THREADS`; the
    grid is the blocks that the card holds at once (by shared memory,
    and at most :data:`GATHER_MIN_BLOCKS` an SM, as its registers allow),
    at most one a tile, and they walk the tiles with a grid-stride loop.
    Raises ``ValueError`` for C above the limit."""
    if C > GATHER_MAX_C:
        raise ValueError(f"the CUDA gather_mix stages a {MIN_TILE}-column tile of all C "
                         f"rows in shared memory, so C <= {GATHER_MAX_C}; got C={C}")
    width = max(_widest(buf | out | N * itemsize), itemsize)
    stage = lambda tile: C * tile * itemsize  # noqa: E731
    table = C * K1 * 8
    tile, stages = MIN_TILE, 1
    for t in GATHER_TILES:
        if 2 * stage(t) + table <= SMEM_BYTES // GATHER_MIN_BLOCKS:
            tile, stages = t, 2
            break
    else:
        if 2 * stage(MIN_TILE) <= SMEM_BYTES:
            stages = 2
    ring = stages * stage(tile)
    keep = ring + table <= SMEM_BYTES
    smem = ring + (table if keep else 0)
    per_sm = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES), GATHER_MIN_BLOCKS)
    tiles = -(-N // tile)
    return LaunchPlan("gather", tile, stages, keep, width, smem, GATHER_THREADS,
                      max(1, min(tiles, per_sm * sms)))


def launch_plan(C: int, K1: int, N: int, itemsize: int, buf: int, out: int,
                sms: int) -> LaunchPlan:
    """The plan of a ``gather_mix`` call: the register body up to
    :data:`REGISTER_MAX_C` rows, the gather body above (arguments as
    :func:`gather_plan`).  Raises ``ValueError`` above
    :data:`GATHER_MAX_C`."""
    if C <= REGISTER_MAX_C:
        return register_plan(C, N, itemsize, buf, out, sms)
    return gather_plan(C, K1, N, itemsize, buf, out, sms)


def _library():
    from .build import load
    lib = load("gather_mix")
    if lib.gather_mix.argtypes is None:
        lib.gather_mix.argtypes = [_ptr, _ptr, _ptr, _ptr, _int, _int, _ll, _int, _int,
                                   _int, _int, _int, _int, _int, _int, _int, _ptr]
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
    above :data:`GATHER_MAX_C`."""
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
    srcs = gather_table(C, srcs, weights)
    if buf.device.type == "cpu":
        res = gather_mix_ref(buf, srcs, weights)
        return res if out is None else out.copy_(res)
    if buf.device.type != "cuda":
        raise ValueError(f"gather_mix runs on cuda or cpu, not {buf.device}")
    if buf.dtype not in _DTYPES:
        raise ValueError(f"the CUDA gather_mix takes float32 or bfloat16, "
                         f"got {buf.dtype}")
    if out is None:
        out = torch.empty_like(buf)
    if not (buf.is_contiguous() and out.is_contiguous()):
        raise ValueError("gather_mix needs contiguous buf and out")
    plan = launch_plan(C, srcs.shape[1], N, buf.element_size(), buf.data_ptr(),
                       out.data_ptr(), _sm_count(buf.device.index))
    return launch(buf, srcs, weights, out, plan)


def launch(buf: torch.Tensor, srcs: torch.Tensor, weights: torch.Tensor,
           out: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """Launch ``plan`` on contiguous CUDA ``buf`` and ``out`` with a checked
    (C, K1) table (:func:`repro_torch.kernels.ref.gather_table`), and count
    it; :func:`gather_mix` calls it with :func:`launch_plan`'s plan, and a
    timing run may pass either body's plan where both serve C."""
    C, N = buf.shape
    s32 = srcs  # int32 where it lies; a wider source outside [0, C) must not wrap into it
    if s32.dtype != torch.int32:
        s32 = s32.clamp(-1, C).to(torch.int32)
    s32 = s32.to(buf.device).contiguous()
    w32 = weights.to(torch.float32).contiguous()
    lib = _library()
    with torch.cuda.device(buf.device):
        err = lib.gather_mix(s32.data_ptr(), w32.data_ptr(), buf.data_ptr(), out.data_ptr(),
                             C, srcs.shape[1], N,
                             int(buf.dtype == torch.bfloat16),
                             int(plan.body == "gather"), plan.tile, plan.stages,
                             int(plan.table), plan.width, plan.smem, plan.threads,
                             plan.blocks,
                             torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError("gather_mix launch failed: "
                           + lib.gather_mix_error_string(err).decode())
    gather_mix.launches += 1
    return out


gather_mix.launches = 0
