"""Data partitioners (numpy; bitwise those of the JAX package): IID and
non-IID partitioning.

``iid_partition`` deals a seeded permutation of the samples into n_nodes
near-equal parts.  ``sharding_partition`` is the 2-sharding non-IID scheme of McMahan et al.:
sort by label, cut into n_nodes*shards contiguous shards, deal each node
``shards_per_node`` of them.
"""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(labels: np.ndarray, n_nodes: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, n_nodes)]


def sharding_partition(
    labels: np.ndarray, n_nodes: int, shards_per_node: int = 2, seed: int = 0
) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_nodes * shards_per_node)
    shard_ids = rng.permutation(n_nodes * shards_per_node)
    return [
        np.sort(np.concatenate([shards[s] for s in shard_ids[i * shards_per_node : (i + 1) * shards_per_node]]))
        for i in range(n_nodes)
    ]


def classes_per_node(labels: np.ndarray, parts: List[np.ndarray]) -> np.ndarray:
    """(N,) number of distinct labels in each node's part."""
    return np.array([len(np.unique(labels[p])) for p in parts])
