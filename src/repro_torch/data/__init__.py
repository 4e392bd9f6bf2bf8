"""Synthetic stand-ins for the paper's datasets and the non-iid
partitions: copies of ``repro/data/synthetic.py`` and ``noniid.py``
(pure numpy; nothing is downloaded)."""

from .noniid import (Partition, biased_locality_partition, iid_partition,
                     shard_partition)
from .synthetic import (CharLMData, ClassificationData, char_lm, cifar_like,
                        mnist_like, token_batches)

__all__ = [
    "Partition", "biased_locality_partition", "iid_partition",
    "shard_partition", "CharLMData", "ClassificationData", "char_lm",
    "cifar_like", "mnist_like", "token_batches",
]
