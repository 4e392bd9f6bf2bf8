"""Token pipelines for the language-model entry points.

The port of ``repro/data/tokens.py``, pure numpy, in part:

* :class:`TokenStream` — a deterministic synthetic stream with learnable
  n-gram structure for the end-to-end runs (no downloaded corpora);
  for any ``(vocab, batch, seq, seed, client)`` it yields the
  reference's arrays exactly;
* :func:`enc_frames_for` — the encoder-memory length of the enc-dec
  family.

The reference's ``input_specs`` (shape stand-ins for the multi-pod dry
run) has no counterpart until the port's dry run (ROADMAP.md Queue 1
item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from ..models.config import ArchConfig


def enc_frames_for(cfg: ArchConfig, seq_len: int) -> int:
    """Encoder-memory length for the enc-dec (audio) family: the modality
    frontend is a stub; its output is sized at 1/4 the decoder length (a
    4x conv-downsampled mel stream), min 128 frames."""
    return max(128, seq_len // 4)


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic next-token batches with short-range n-gram
    structure (the loss drops measurably within a few hundred steps).

    ``client`` skews the n-gram table per DFL client: non-iid shards.
    Each item is ``(tokens, labels)``, two (batch, seq_len) int32 arrays.
    """

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    client: int = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed * 1000003 + self.client)
        mult = int(rng.integers(3, 64)) * 2 + 1
        add = int(rng.integers(1, self.vocab_size))
        while True:
            base = rng.integers(0, self.vocab_size,
                                size=(self.batch, self.seq_len + 1))
            dep = (base[:, :-1] * mult + add) % self.vocab_size
            gate = rng.random((self.batch, self.seq_len)) < 0.7
            nxt = np.where(gate, dep, base[:, 1:])
            full = np.concatenate([base[:, :1], nxt], axis=1)
            yield (full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32))

    def batches(self, n: int):
        it = iter(self)
        for _ in range(n):
            yield next(it)
