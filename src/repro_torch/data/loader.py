"""Per-node batch indices, bitwise those of the JAX package.

Two keyings (``DLConfig.batch_keying``):

* ``"stream"`` — one numpy PCG64 stream per round fills a (steps, N, B)
  uniform block, mapped onto each node's partition on the host;
* ``"node"`` — :func:`node_batch_indices`: each (round, node) pair owns a
  Threefry stream, ``fold_in(fold_in(key, round), id)`` through
  ``repro_torch.prng``, so the indices of any subset of rows (a gathered
  cohort) are computed on the device and equal those of the full
  population.

The engine keeps the dataset on the device and gathers each round's batch
there by these indices.  The federated runner samples per node instead
(:meth:`NodeBatcher.batch`).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import prng


class NodeBatcher:
    def __init__(self, data_x: np.ndarray, data_y: np.ndarray,
                 parts: List[np.ndarray], batch_size: int, seed: int = 0):
        self.x, self.y = data_x, data_y
        self.parts = parts
        self.bs = batch_size
        self.seed = seed
        self.n_nodes = len(parts)

        lens = np.array([len(p) for p in parts], np.int64)
        if (lens == 0).any():
            raise ValueError(
                f"empty partition for node(s) {np.nonzero(lens == 0)[0].tolist()}: "
                "n_nodes * shards_per_node exceeds the dataset size"
            )
        pad = np.zeros((self.n_nodes, int(lens.max())), np.int64)
        for i, p in enumerate(parts):
            pad[i, : len(p)] = p
            pad[i, len(p):] = p[0]
        self._lens, self._parts_pad = lens, pad

    def batch(self, round_idx: int, step: int = 0):
        """(xs (N, B, ...), ys (N, B)) numpy batches, node i's drawn by its
        own ``default_rng`` stream of (seed, round, step, i), without
        replacement where its partition holds at least B samples (the
        federated runner's sampler)."""
        xs, ys = [], []
        for i, part in enumerate(self.parts):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + round_idx) * 1_000_003 + step * 65_537 + i
            )
            take = rng.choice(part, self.bs, replace=len(part) < self.bs)
            xs.append(self.x[take])
            ys.append(self.y[take])
        return np.stack(xs), np.stack(ys)

    def round_indices(self, round_idx: int, steps: int = 1) -> np.ndarray:
        """(steps, N, B) int32 global sample indices for one round, drawn
        uniformly with replacement from each node's partition.  A pure
        function of the round, so chunking never changes the data."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + round_idx) * 1_000_003 + 99_991
        )
        u = rng.random((steps, self.n_nodes, self.bs))
        loc = (u * self._lens[None, :, None]).astype(np.int64)
        return self._parts_pad[
            np.arange(self.n_nodes)[None, :, None], loc
        ].astype(np.int32)

    def chunk_indices(self, start_round: int, n_rounds: int, steps: int = 1) -> np.ndarray:
        """(R, steps, N, B) int32 indices for rounds [start, start+R)."""
        return np.stack(
            [self.round_indices(start_round + r, steps) for r in range(n_rounds)]
        )

    def test_batch(self, max_n: int = 512):
        return self.x[:max_n], self.y[:max_n]

    def device_tables(self, device):
        """(lens (N,) fp32, parts_pad (N, maxlen) int64) on ``device``: the
        partition tables :func:`node_batch_indices` samples from."""
        return (torch.as_tensor(self._lens.astype(np.float32), device=device),
                torch.as_tensor(self._parts_pad, device=device))


def node_batch_indices(base_key, round_idx: int, ids, lens, parts_pad,
                       local_steps: int, batch_size: int):
    """(L, n, B) int64 global sample indices for the global node ids
    ``ids`` (an int64 tensor on the tables' device): row i draws the fp32
    uniforms of ``fold_in(fold_in(base_key, round_idx), ids[i])`` over
    (L, B) and truncates ``u * len`` into its padded partition row.  A pure
    function of (key, round, id), so any subset of rows draws what the
    full population draws for it."""
    rk = prng.fold_in(base_key, int(round_idx))
    u = prng.uniform(prng.fold_in(rk, ids.reshape(-1, 1)), (local_steps, batch_size))
    loc = (u * lens[ids][:, None, None]).to(torch.int64)   # (n, L, B)
    return parts_pad[ids[:, None, None], loc].movedim(0, 1)
