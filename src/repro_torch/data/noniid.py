"""Non-iid data partitioning (paper §IV-A2, "Learning with non-iid data").

The paper generates non-iid client datasets by *sharding*: the training
set is sorted by label and split into shards, each shard containing only
one label; each client receives a limited number of shards.  Fewer
shards per client ⇒ more non-iid.  We implement exactly that, plus the
paper's *biased-locality* grouping (each of 10 groups holds 6 of 10
labels, shifted by one label per group) used in §IV-C.

A copy of ``repro/data/noniid.py`` (pure numpy): the same seed gives the
same partition.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Partition:
    """client -> example indices, plus label bookkeeping."""

    client_indices: List[np.ndarray]
    num_classes: int

    def label_histogram(self, labels: np.ndarray, client: int) -> np.ndarray:
        h = np.bincount(labels[self.client_indices[client]], minlength=self.num_classes)
        return h.astype(np.float64)

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)


def shard_partition(labels: np.ndarray, num_clients: int, shards_per_client: int,
                    num_classes: Optional[int] = None, seed: int = 0,
                    allow_overlap: bool = False) -> Partition:
    """The paper's sharding method.

    Sort by label, cut into ``num_clients * shards_per_client`` single-
    label shards, deal ``shards_per_client`` random shards to each
    client.  ``allow_overlap=True`` reuses shards when there are more
    clients than data supports (the paper's large-scale-simulation mode).
    """
    labels = np.asarray(labels)
    num_classes = num_classes or int(labels.max()) + 1
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    total_shards = num_clients * shards_per_client
    shards = np.array_split(order, total_shards)
    if allow_overlap:
        assignment = rng.integers(0, total_shards, size=total_shards)
    else:
        assignment = rng.permutation(total_shards)
    client_indices = []
    for c in range(num_clients):
        ids = assignment[c * shards_per_client:(c + 1) * shards_per_client]
        client_indices.append(np.concatenate([shards[i] for i in ids]))
    return Partition(client_indices=client_indices, num_classes=num_classes)


def biased_locality_partition(labels: np.ndarray, num_clients: int,
                              num_groups: int = 10, labels_per_group: int = 6,
                              samples_per_label: int = 200, seed: int = 0) -> Partition:
    """§IV-C biased-locality setting: clients split evenly into groups;
    group g holds labels {g, g+1, .., g+labels_per_group-1} (mod K), i.e.
    adjacent groups differ by exactly one label."""
    labels = np.asarray(labels)
    num_classes = int(labels.max()) + 1
    rng = np.random.default_rng(seed)
    by_label = [np.nonzero(labels == k)[0] for k in range(num_classes)]
    client_indices = []
    for c in range(num_clients):
        g = c * num_groups // num_clients
        idx = []
        for off in range(labels_per_group):
            k = (g + off) % num_classes
            take = rng.choice(by_label[k], size=min(samples_per_label, len(by_label[k])),
                              replace=len(by_label[k]) < samples_per_label)
            idx.append(take)
        client_indices.append(np.concatenate(idx))
    return Partition(client_indices=client_indices, num_classes=num_classes)


def iid_partition(labels: np.ndarray, num_clients: int, seed: int = 0) -> Partition:
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    return Partition(client_indices=list(np.array_split(order, num_clients)),
                     num_classes=int(labels.max()) + 1)
