"""Wire codecs: compressed gossip on the flat buffer.

The port of ``repro/wire/codec.py``.  A :class:`WireCodec` maps the
(B, N) f32 row buffer of :class:`repro_torch.dist.flat.FlatSpec` to the
tuple of tensors that would cross the network (``encode``), back
(``decode``), and prices it (``wire_bytes``).  Two receives fold the
*encoded* rows: :func:`repro_torch.dist.sync.global_mixer` mixes the
encoded population through :meth:`WireCodec.gather`, and the per-rank
:func:`repro_torch.dist.sync.fedlay_mix` folds each slot's received rows
into its accumulator through :meth:`WireCodec.accumulate`.

**The wire-format contract** (the reference's, unchanged):

* ``encode(buf) -> wire``: a tuple of tensors with buf's leading dim,
  whose shapes and dtypes are functions of (N, codec) alone;
* ``decode(wire, n) -> (B, n) f32``: the receiver's image; ``n`` is the
  original column count;
* ``wire_bytes(n)``: exact bytes an encoded row puts on the wire, the
  closed form :func:`repro_torch.dist.sync.sync_bytes_per_client`
  multiplies in; ``payload_bytes(n)`` the value payload alone;
* ``exact=True`` means decode ∘ encode is the bit-exact identity on f32;
  lossy codecs bound the element-wise error by :meth:`tolerance`;
* ``error_feedback=True`` codecs send ``enc(x + e)`` and carry the new
  residual ``e' = (x + e) − dec(enc(x + e))`` per slot
  (:class:`repro_torch.runtime.loop.SlotTrainLoop`); a masked-out row
  keeps its residual, joiner and leaver slots are zeroed.

=============  =======  ===  ==========================================
name           bytes/N  EF   exactness
=============  =======  ===  ==========================================
``none``       4 N      no   bit-exact (the plumbing's control arm)
``bf16``       2 N      no   bit-exact on bf16 values, else ≤ |x|·2⁻⁸
``int8-block`` ~1.02 N  yes  ≤ max|block| / 127 (documented test bound)
``int4-block`` ~0.52 N  yes  ≤ max|block| / 7
``topk``       8 k      yes  kept entries exact, dropped ones lose |x|
=============  =======  ===  ==========================================

The block codecs run the kernels of :mod:`repro_torch.kernels.wire_codec`:
``quantize_block`` encodes (with the residual in the same pass);
int8-block's receives are ``gather_mix_int8`` and ``dequant_accumulate``,
which dequantize in registers; int4-block's are ``dequantize_block`` then
``gather_mix`` or ``mix_accumulate`` (the reference's generic
decode-then-mix routes, ``codec.py:141-156``).
Its nibble packing is tensor byte work on ``quantize_block``'s output,
as in the reference.  topk ranks with ``torch.topk`` (the reference's
``jax.lax.top_k`` is no Pallas kernel).

**Buffers.**  Beyond the reference's functions, the port's
``encode``, ``encode_ef``, ``decode`` and ``gather`` take the buffers
they write: ``workspace(B, n, device)`` allocates a codec's wire once
(int8-block: q and the scales; int4-block: q, the scales and the
packed nibbles), ``residual_out`` may be the encoded buffer itself, and
``out`` receives a decode or a round, so a training loop that holds
them reallocates nothing from round to round.

Codecs are frozen dataclasses, hashable and value-equal, so the
controller's ``MixerCache`` keys mixers on ``(schedule, fuse, codec)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels.gather_mix import gather_mix
from ..kernels.mix_accumulate import mix_accumulate
from ..kernels.wire_codec import (dequant_accumulate, dequantize_block, gather_mix_int8,
                                  padded_width, quantize_block)

Wire = Tuple[torch.Tensor, ...]
Workspace = Dict[str, torch.Tensor]


def _block_amax_bound(buf: torch.Tensor, block: int, levels: int) -> torch.Tensor:
    """max|block| / levels, repeated over each block's columns, (B, n)."""
    x = buf.float()
    B, n = x.shape
    nb = -(-n // block)
    xp = torch.zeros((B, nb * block), dtype=torch.float32, device=x.device)
    xp[:, :n] = x
    amax = xp.view(B, nb, block).abs().amax(dim=2)
    return torch.repeat_interleave(amax / levels, block, dim=1)[:, :n]


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Base codec: the coding API plus the generic (decode-then-mix)
    receive hooks that codecs with a fused kernel override."""

    #: registry name (class attribute on subclasses)
    name = "abstract"
    #: decode ∘ encode is the bit-exact f32 identity
    exact = False
    #: the mixer carries a compensated residual for this codec
    error_feedback = False

    # ---- the coding pair -------------------------------------------------
    def workspace(self, B: int, n: int, device) -> Workspace:
        """The buffers ``encode`` writes for a (B, n) buffer, allocated
        once by a caller that encodes every round (none by default:
        the codec allocates its wire)."""
        return {}

    def encode(self, buf: torch.Tensor, ws: Optional[Workspace] = None) -> Wire:
        raise NotImplementedError

    def decode(self, wire: Wire, n: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, n) f32, written into ``out`` when given."""
        raise NotImplementedError

    def wire_bytes(self, n: int) -> int:
        """Exact bytes one encoded n-column row puts on the wire."""
        raise NotImplementedError

    def payload_bytes(self, n: int) -> int:
        """Bytes of the value payload alone, without the per-block scales
        (== :meth:`wire_bytes` for codecs without them)."""
        return self.wire_bytes(n)

    def tolerance(self, buf: torch.Tensor) -> torch.Tensor:
        """Element-wise upper bound on |decode(encode(buf)) − buf|."""
        raise NotImplementedError

    # ---- error feedback --------------------------------------------------
    def encode_ef(self, buf: torch.Tensor, ws: Optional[Workspace] = None,
                  residual_out: Optional[torch.Tensor] = None
                  ) -> Tuple[Wire, torch.Tensor]:
        """(wire, residual = buf − decode(wire)); the residual goes into
        ``residual_out`` when given, which may be ``buf``.  The generic
        form decodes once; the block codecs take the residual from the
        quantize kernel."""
        wire = self.encode(buf, ws)
        res = buf.float() - self.decode(wire, buf.shape[1])
        return wire, res if residual_out is None else residual_out.copy_(res)

    # ---- receive hooks ---------------------------------------------------
    def accumulate(self, acc: torch.Tensor, wire: Wire, w: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``acc + w[:, None]·decode(wire)``, the per-rank mixer's receive
        fold, written into ``out`` when given (which may be ``acc``): the
        generic form decodes into one buffer, then ``mix_accumulate``."""
        return mix_accumulate(acc, self.decode(wire, acc.shape[1]), w, out=out)

    def gather(self, wire: Wire, srcs, weights: torch.Tensor, n: int,
               out: Optional[torch.Tensor] = None,
               ws: Optional[Workspace] = None) -> torch.Tensor:
        """The round-matrix mixing of the encoded population, (C, n) f32
        into ``out`` when given: the generic form decodes into ``out``
        and mixes it there with ``gather_mix``, in place."""
        decoded = self.decode(wire, n, out=out)
        return gather_mix(decoded, srcs, weights, out=decoded)


@dataclasses.dataclass(frozen=True)
class NoneCodec(WireCodec):
    """Identity codec: the f32 row itself routed through the codec
    plumbing, the exactness control arm."""

    name = "none"
    exact = True

    def encode(self, buf, ws=None):
        return (buf.float(),)

    def decode(self, wire, n, out=None):
        rows = wire[0][:, :n]
        return rows if out is None else out.copy_(rows)

    def wire_bytes(self, n):
        return 4 * n

    def tolerance(self, buf):
        return torch.zeros_like(buf, dtype=torch.float32)

    def gather(self, wire, srcs, weights, n, out=None, ws=None):
        # the wire is the population itself: mix it where it lies
        return gather_mix(self.decode(wire, n).contiguous(), srcs, weights, out=out)


@dataclasses.dataclass(frozen=True)
class Bf16Codec(WireCodec):
    """The row rounded to bf16 (2 bytes an element), carried as its 16
    bits in an int16 tensor, as the reference carries them in uint16.
    Bit-exact on values already in bf16, |err| ≤ |x|·2⁻⁸ otherwise; no
    error feedback.  The receive decodes to f32 before mixing, so the
    kernels accumulate in f32."""

    name = "bf16"

    def encode(self, buf, ws=None):
        return (buf.to(torch.bfloat16).view(torch.int16),)

    def decode(self, wire, n, out=None):
        bits = wire[0].view(torch.bfloat16)[:, :n]
        return bits.float() if out is None else out.copy_(bits)

    def wire_bytes(self, n):
        return 2 * n

    def tolerance(self, buf):
        return buf.float().abs() * 2.0 ** -8


@dataclasses.dataclass(frozen=True)
class Int8BlockCodec(WireCodec):
    """Symmetric per-block int8 quantization (about 4× less wire): one
    bf16 scale s = max|block| / 127 per ``block`` columns and
    q = round(x / s) in [-127, 127], through ``quantize_block``; the
    receives dequantize inside ``gather_mix_int8`` (the global round) and
    ``dequant_accumulate`` (the per-rank fold).  Error feedback
    compensates the ≤ s/2 rounding."""

    block: int = 128

    name = "int8-block"
    error_feedback = True
    levels = 127

    def workspace(self, B, n, device):
        Np = padded_width(n, self.block)
        return {"q": torch.empty((B, Np), dtype=torch.int8, device=device),
                "scales": torch.empty((B, Np // self.block), dtype=torch.bfloat16,
                                      device=device)}

    def _quantize(self, buf, ws, residual_out=None, with_residual=False):
        ws = ws or {}
        return quantize_block(buf, block=self.block, levels=self.levels,
                              with_residual=with_residual, q_out=ws.get("q"),
                              scales_out=ws.get("scales"), residual_out=residual_out)

    def encode(self, buf, ws=None):
        return self._quantize(buf, ws)

    def encode_ef(self, buf, ws=None, residual_out=None):
        q, s, res = self._quantize(buf, ws, residual_out, with_residual=True)
        return (q, s), res

    def decode(self, wire, n, out=None):
        q, s = wire
        if out is None:
            return dequantize_block(q, s, block=self.block)[:, :n]
        return dequantize_block(q, s, block=self.block, out=out)

    def wire_bytes(self, n):
        nb = -(-n // self.block)
        return nb * self.block + 2 * nb          # int8 payload + bf16 scales

    def payload_bytes(self, n):
        return -(-n // self.block) * self.block  # 1 byte an element, padded

    def tolerance(self, buf):
        return _block_amax_bound(buf, self.block, self.levels)

    def accumulate(self, acc, wire, w, out=None):
        q, s = wire
        return dequant_accumulate(acc, q, s, w, block=self.block, out=out)

    def gather(self, wire, srcs, weights, n, out=None, ws=None):
        q, s = wire
        if out is None:
            return gather_mix_int8(q, s, srcs, weights, block=self.block)[:, :n]
        return gather_mix_int8(q, s, srcs, weights, block=self.block, out=out)


@dataclasses.dataclass(frozen=True)
class Int4BlockCodec(WireCodec):
    """4-bit symmetric per-block quantization (about 8× less wire):
    levels ±7, two values a byte as biased nibbles (byte =
    (q[2i+1] + 8)·16 + (q[2i] + 8)), bf16 scales as in int8-block.  The
    packing is byte work on ``quantize_block``'s q; the receive unpacks,
    decodes with ``dequantize_block`` and mixes with ``gather_mix``."""

    block: int = 128

    name = "int4-block"
    error_feedback = True
    levels = 7

    def _pack_width(self, n: int) -> int:
        return -(-padded_width(n, self.block) // 2)

    def workspace(self, B, n, device):
        Np = padded_width(n, self.block)
        return {"q": torch.empty((B, Np), dtype=torch.int8, device=device),
                "scales": torch.empty((B, Np // self.block), dtype=torch.bfloat16,
                                      device=device),
                "packed": torch.empty((B, self._pack_width(n)), dtype=torch.uint8,
                                      device=device)}

    def _pack(self, q: torch.Tensor, packed: Optional[torch.Tensor]) -> torch.Tensor:
        """Bias q by 8 in place (so q holds the nibbles afterwards) and
        pack pairs of them into bytes."""
        B, Np = q.shape
        if packed is None:
            packed = torch.empty((B, -(-Np // 2)), dtype=torch.uint8, device=q.device)
        qb = q.view(torch.uint8).add_(8)
        torch.bitwise_left_shift(qb[:, 1::2], 4, out=packed[:, :Np // 2])
        if Np % 2:
            packed[:, -1] = 0
        return packed.bitwise_or_(qb[:, 0::2])

    def _encode(self, buf, ws, residual_out, with_residual):
        ws = ws or {}
        out = quantize_block(buf, block=self.block, levels=self.levels,
                             with_residual=with_residual, q_out=ws.get("q"),
                             scales_out=ws.get("scales"), residual_out=residual_out)
        return (self._pack(out[0], ws.get("packed")), out[1]), out[2:]

    def encode(self, buf, ws=None):
        return self._encode(buf, ws, None, False)[0]

    def encode_ef(self, buf, ws=None, residual_out=None):
        wire, (res,) = self._encode(buf, ws, residual_out, True)
        return wire, res

    def _unpack(self, packed: torch.Tensor, n: int,
                q: Optional[torch.Tensor]) -> torch.Tensor:
        """The (B, NB·block) int8 q of a packed wire, into ``q`` when given."""
        B = packed.shape[0]
        Np = padded_width(n, self.block)
        if q is None:
            q = torch.empty((B, Np), dtype=torch.int8, device=packed.device)
        qb = q.view(torch.uint8)
        torch.bitwise_and(packed[:, :-(-Np // 2)], 0xF, out=qb[:, 0::2])
        torch.bitwise_right_shift(packed[:, :Np // 2], 4, out=qb[:, 1::2])
        return q.sub_(8)

    def decode(self, wire, n, out=None, ws=None):
        packed, s = wire
        q = self._unpack(packed, n, (ws or {}).get("q"))
        if out is None:
            return dequantize_block(q, s, block=self.block)[:, :n]
        return dequantize_block(q, s, block=self.block, out=out)

    def wire_bytes(self, n):
        nb = -(-n // self.block)
        return self._pack_width(n) + 2 * nb

    def payload_bytes(self, n):
        return self._pack_width(n)               # half a byte an element, padded

    def tolerance(self, buf):
        return _block_amax_bound(buf, self.block, self.levels)

    def gather(self, wire, srcs, weights, n, out=None, ws=None):
        decoded = self.decode(wire, n, out=out, ws=ws)
        return gather_mix(decoded, srcs, weights, out=decoded)


@dataclasses.dataclass(frozen=True)
class TopKCodec(WireCodec):
    """Magnitude top-k sparsification: each row keeps its k largest-|x|
    entries as (values f32, indices int32), 8k bytes, k =
    max(1, round(rate·n)).  Kept entries are exact and dropped ones are
    the error, so it runs with error feedback."""

    rate: float = 0.0625

    name = "topk"
    error_feedback = True

    def __post_init__(self):
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"topk rate {self.rate} not in (0, 1]")

    def k_for(self, n: int) -> int:
        return max(1, int(round(self.rate * n)))

    def _top(self, x: torch.Tensor):
        idx = torch.topk(x.abs(), self.k_for(x.shape[1]), dim=1).indices
        return torch.gather(x, 1, idx), idx

    def encode(self, buf, ws=None):
        vals, idx = self._top(buf.float())
        return vals, idx.to(torch.int32)

    def encode_ef(self, buf, ws=None, residual_out=None):
        x = buf.float()
        vals, idx = self._top(x)
        res = x.clone() if residual_out is None else residual_out.copy_(x)
        return (vals, idx.to(torch.int32)), res.scatter_(1, idx, 0.0)

    def decode(self, wire, n, out=None):
        vals, idx = wire
        if out is None:
            out = torch.empty((vals.shape[0], n), dtype=torch.float32, device=vals.device)
        return out.zero_().scatter_add_(1, idx.long(), vals)

    def wire_bytes(self, n):
        return 8 * self.k_for(n)

    def tolerance(self, buf):
        # dropped entries lose their whole value; kept ones are exact
        return buf.float().abs()


#: Registry of default codec instances by name (CLI / config currency).
WIRE_CODECS = {c.name: c for c in (
    NoneCodec(), Bf16Codec(), Int8BlockCodec(), Int4BlockCodec(), TopKCodec())}


def get_codec(codec: Union[None, str, WireCodec]) -> Optional[WireCodec]:
    """Resolve a codec knob: None → no codec, a registry name → its
    default instance, an instance → itself."""
    if codec is None or isinstance(codec, WireCodec):
        return codec
    got = WIRE_CODECS.get(codec)
    if got is None:
        raise ValueError(f"unknown wire codec {codec!r}; choose from "
                         f"{tuple(WIRE_CODECS)}")
    return got
