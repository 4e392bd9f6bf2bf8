"""``ssd_scan``: the Mamba2 SSD chunked scan (state-space duality).

The port of ``repro/kernels/ssd_scan.py:ssd_scan`` (a Pallas TPU kernel).
x (B, S, H, P), dt (B, S, H) after softplus, A (H,) negative, and
single-group Bm, Cm (B, S, N) give y (B, S, H, P) in x's dtype, by the
chunked dual form over chunks of ``chunk_len(S, chunk)`` rows, f32 math,
from a zero state.  The state after the last step, (B, H, P, N) f32, is
always written out: into ``state_out`` when the caller passes it (a
cache's rows), else into a new tensor (the TPU kernel drops it; a
prefill primes the decode cache with it).

On a CUDA tensor this runs ``csrc/ssd_scan.cu`` (its header says what
bounds it and how each pass is laid out), and raises if the build or a
launch fails; on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.ssd_chunked_ref`.  A call on the card is
three launches on the current stream, with no synchronisation: the
chunks' own states, the state passing from chunk to chunk, and the
chunks' outputs.  Between them the passes keep two scratch tensors that
this wrapper allocates with ``torch.empty`` and drops on return: the
states (B, S/Q, H, P, N) f32 (0.537 GB at Mamba2-370m's 4 x 32,768-token
prefill) and the within-chunk cumsum of dt·A (B, S/Q, H, Q) f32.

The kernel takes x, Bm and Cm as row-strided views (the conv output's
slices in a prefill) as long as their inner dims are dense: x's (H, P)
and Bm's and Cm's N.  It serves P and N of 32, 64 or 128, chunks of at
most 1024 rows (ragged ones too), f32 or bf16 for x, Bm and Cm alike, and
any B·H up to 2^31 − 1.

``ssd_scan.launches`` counts calls that launched the kernel, one a call
whatever the number of passes; the plain path does not count.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .ref import chunk_len, ssd_chunked_ref

WIDTHS = (32, 64, 128)     # the P (headdim) and N (d_state) the kernel serves
MAX_CHUNK = 1024           # longest chunk: its cumsum lives in shared memory
_DTYPES = (torch.float32, torch.bfloat16)
_ptr, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    from .build import load
    lib = load("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        lib.ssd_scan.argtypes = ([_ptr] * 9 + [_int] * 6 + [_ll] * 6
                                 + [_int, _ptr])
        lib.ssd_scan.restype = _int
        lib.ssd_scan_error_string.argtypes = [_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256,
             state_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N) → (y
    (B, S, H, P) in x's dtype, final state (B, H, P, N) f32); the final
    state is ``state_out`` when given, else a new tensor.

    Raises ``ValueError`` for shapes that do not agree, mixed devices, a
    state buffer of another shape, dtype or device, and, on the card, for
    a P or N outside (32, 64, 128), a chunk over 1024 rows, dtypes other
    than f32 / bf16 (x, Bm, Cm alike) and f32 (dt, A), and inner dims
    that are not dense."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, t, shape in (("dt", dt, (Bsz, S, H)), ("A", A, (H,)),
                           ("Bm", Bm, (Bsz, S, N)), ("Cm", Cm, (Bsz, S, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    Q = chunk_len(S, chunk)
    if state_out is None:
        state_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    elif (tuple(state_out.shape) != (Bsz, H, P, N)
          or state_out.dtype != torch.float32 or state_out.device != x.device):
        raise ValueError(
            f"state_out must be a {(Bsz, H, P, N)} float32 tensor on {x.device}; "
            f"got {tuple(state_out.shape)} {state_out.dtype} on {state_out.device}")
    if x.device.type == "cpu":
        y, final = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
        return y, state_out.copy_(final)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"the CUDA ssd_scan takes x, Bm and Cm all float32 or all "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"the CUDA ssd_scan takes float32 dt and A, got "
                         f"{dt.dtype}, {A.dtype}")
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"the CUDA ssd_scan serves headdim P and d_state N in "
                         f"{WIDTHS}, got P={P}, N={N}")
    if Q > MAX_CHUNK:
        raise ValueError(f"the CUDA ssd_scan takes chunks of at most {MAX_CHUNK} "
                         f"rows, got {Q}")
    if x.stride(3) != 1 or x.stride(2) != P or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("ssd_scan needs x's (H, P) dims and Bm's and Cm's N dim "
                         "dense")
    if not all(t.is_contiguous() for t in (dt, A, state_out)):
        raise ValueError("ssd_scan needs contiguous dt, A and state_out")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    nc = S // Q
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=x.device)
    cums = torch.empty((Bsz, nc, H, Q), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state_out.data_ptr(),
            states.data_ptr(), cums.data_ptr(), Bsz, S, H, P, N, Q,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
            Cm.stride(1),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_scan.launches += 1
    return y, state_out


ssd_scan.launches = 0
