"""Synthetic stand-ins for the paper's datasets (offline container — no
MNIST/CIFAR-10/Shakespeare downloads).

Shapes and label structure mirror the originals so the paper's non-iid
sharding protocol, models, and relative method orderings carry over:

* ``mnist_like``   — 10-class 8×8 "digit" images: class-specific
  prototype strokes + pixel noise (MLP task).
* ``cifar_like``   — 10-class 16×16×3 images: class-specific color/
  texture patterns + noise (CNN task).
* ``char_lm``      — role-conditioned Markov character streams over a
  vocabulary of 32 chars; each "speaking role" (client shard) has its
  own transition bias, mirroring Shakespeare's per-role sharding
  (LSTM next-character task).

A copy of ``repro/data/synthetic.py`` (pure numpy): the same seed gives
bit-equal arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ClassificationData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def mnist_like(n_train: int = 4000, n_test: int = 1000, image: int = 8,
               noise: float = 0.7, seed: int = 0) -> ClassificationData:
    """10 classes of 8x8 images built from class prototypes + noise."""
    rng = np.random.default_rng(seed)
    k = 10
    protos = rng.normal(0, 1, size=(k, image * image))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)

    def sample(n):
        y = rng.integers(0, k, size=n)
        x = protos[y] + noise * rng.normal(0, 1, size=(n, image * image)) / np.sqrt(image * image)
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return ClassificationData(xtr, ytr, xte, yte, k)


def cifar_like(n_train: int = 4000, n_test: int = 1000, image: int = 16,
               noise: float = 1.0, seed: int = 0) -> ClassificationData:
    """10 classes of 16x16x3 images: per-class low-frequency pattern +
    color bias + iid noise — hard enough that a linear model underfits
    but a small CNN separates (mirrors the paper's CIFAR accuracy band).
    """
    rng = np.random.default_rng(seed)
    k = 10
    yy, xx = np.mgrid[0:image, 0:image].astype(np.float32) / image
    patterns = []
    for c in range(k):
        fx, fy = rng.integers(1, 4, size=2)
        phase = rng.random(2) * 2 * np.pi
        pat = np.sin(2 * np.pi * fx * xx + phase[0]) * np.cos(2 * np.pi * fy * yy + phase[1])
        color = rng.normal(0, 1, size=3)
        patterns.append(pat[..., None] * color[None, None, :])
    patterns = np.stack(patterns)  # (k, H, W, 3)

    def sample(n):
        y = rng.integers(0, k, size=n)
        x = patterns[y] + noise * rng.normal(0, 1, size=(n, image, image, 3))
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return ClassificationData(xtr, ytr, xte, yte, k)


@dataclasses.dataclass
class CharLMData:
    """Role-sharded character streams (one role ≈ one client shard)."""

    role_streams: np.ndarray   # (num_roles, stream_len) int32 tokens
    role_labels: np.ndarray    # (num_roles,) pseudo-label = dominant char class
    test_stream: np.ndarray    # (test_len,) mixture of all roles
    vocab_size: int


def char_lm(num_roles: int = 64, stream_len: int = 2048, test_len: int = 8192,
            vocab: int = 32, seed: int = 0) -> CharLMData:
    """Markov text: a shared base transition matrix + per-role bias toward
    a role-specific subset of characters (the non-iid structure)."""
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.ones(vocab) * 0.5, size=vocab)  # (v, v)
    streams = np.zeros((num_roles, stream_len), dtype=np.int32)
    role_labels = np.zeros(num_roles, dtype=np.int32)
    for r in range(num_roles):
        fav = rng.choice(vocab, size=4, replace=False)
        role_labels[r] = fav[0] % 10
        T = base.copy()
        T[:, fav] *= 4.0
        T /= T.sum(axis=1, keepdims=True)
        s = rng.integers(vocab)
        for t in range(stream_len):
            streams[r, t] = s
            s = rng.choice(vocab, p=T[s])
    # test stream: mixture of role dynamics
    test = np.zeros(test_len, dtype=np.int32)
    s = rng.integers(vocab)
    T = base / base.sum(axis=1, keepdims=True)
    for t in range(test_len):
        test[t] = s
        s = rng.choice(vocab, p=T[s])
    return CharLMData(streams, role_labels, test, vocab)


# --------------------------------------------------------------------------
# Token-stream pipeline for LM-scale training (used by launch/train.py)
# --------------------------------------------------------------------------

def token_batches(vocab_size: int, batch: int, seq_len: int, num_batches: int,
                  seed: int = 0):
    """Deterministic synthetic next-token batches: a linear-congruential
    sequence with learnable short-range structure — enough for loss to
    drop measurably in a few hundred steps."""
    rng = np.random.default_rng(seed)
    mix = rng.integers(1, vocab_size, size=7)
    for b in range(num_batches):
        base = rng.integers(0, vocab_size, size=(batch, seq_len + 1))
        # inject n-gram structure: x[t+1] depends on x[t] half the time
        dep = (base[:, :-1] * 31 + mix[b % 7]) % vocab_size
        gate = rng.random((batch, seq_len)) < 0.5
        tokens = np.where(gate, dep, base[:, 1:])
        full = np.concatenate([base[:, :1], tokens], axis=1)
        yield full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)
