"""Synthetic stand-ins for the paper's datasets, the non-iid partitions
and the language models' token streams: copies of
``repro/data/synthetic.py``, ``noniid.py`` and ``tokens.py`` (pure
numpy; nothing is downloaded)."""

from .noniid import (Partition, biased_locality_partition, iid_partition,
                     shard_partition)
from .synthetic import (CharLMData, ClassificationData, char_lm, cifar_like,
                        mnist_like, token_batches)
from .tokens import TokenStream, enc_frames_for

__all__ = [
    "Partition", "biased_locality_partition", "iid_partition",
    "shard_partition", "CharLMData", "ClassificationData", "char_lm",
    "cifar_like", "mnist_like", "token_batches", "TokenStream",
    "enc_frames_for",
]
