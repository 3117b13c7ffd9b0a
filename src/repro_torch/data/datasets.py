"""Dataset module: seeded synthetic stand-ins for the paper's workloads.

numpy only, so the arrays are bitwise those of the JAX package's
``data/datasets.py`` for the same seed.  10-class 32x32x3 images
(CIFAR-like) from class prototypes, or labels from a random teacher MLP,
and a learnable token stream (class-conditional Markov chains) for the
language-model trainer.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticImages:
    """k-Gaussian-blob image classification, CIFAR-10-shaped by default:
    each class has a fixed random prototype image, and a sample is the
    prototype plus ``sigma`` times noise."""

    n_train: int = 12_800
    n_test: int = 2_048
    n_classes: int = 10
    shape: Tuple[int, int, int] = (32, 32, 3)
    sigma: float = 1.0
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.prototypes = rng.normal(0, 1, (self.n_classes, *self.shape)).astype(np.float32)
        self.train_x, self.train_y = self._gen(rng, self.n_train)
        self.test_x, self.test_y = self._gen(rng, self.n_test)

    def _gen(self, rng, n):
        y = rng.integers(0, self.n_classes, n)
        x = self.prototypes[y] + self.sigma * rng.normal(0, 1, (n, *self.shape)).astype(np.float32)
        # unit-ish input variance whatever sigma is (sigma sets Bayes error)
        x = x / np.sqrt(1.0 + self.sigma**2)
        return x.astype(np.float32), y.astype(np.int32)

    @property
    def kind(self):
        return "images"


@dataclasses.dataclass
class TeacherImages:
    """Teacher-student image classification: labels from a fixed random
    2-layer MLP teacher over Gaussian images."""

    n_train: int = 12_800
    n_test: int = 2_048
    n_classes: int = 10
    shape: Tuple[int, int, int] = (32, 32, 3)
    teacher_hidden: int = 48
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        d = int(np.prod(self.shape))
        self._w1 = rng.normal(0, d**-0.5, (d, self.teacher_hidden)).astype(np.float32)
        self._w2 = rng.normal(0, self.teacher_hidden**-0.5,
                              (self.teacher_hidden, self.n_classes)).astype(np.float32)
        self.train_x, self.train_y = self._gen(rng, self.n_train)
        self.test_x, self.test_y = self._gen(rng, self.n_test)

    def _gen(self, rng, n):
        x = rng.normal(0, 1, (n, *self.shape)).astype(np.float32)
        h = np.tanh(x.reshape(n, -1) @ self._w1)
        y = (h @ self._w2).argmax(-1).astype(np.int32)
        return x, y

    @property
    def kind(self):
        return "images"


@dataclasses.dataclass
class SyntheticLM:
    """Token stream with learnable bigram structure: each sequence follows
    one of ``n_classes`` sparse Markov chains (its "document class", the
    label non-IID sharding splits by)."""

    n_train: int = 4_096      # number of sequences
    n_test: int = 512
    seq_len: int = 64
    vocab: int = 128
    n_classes: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        trans = rng.dirichlet(np.full(self.vocab, 0.05), (self.n_classes, self.vocab))
        self.trans = trans.astype(np.float64)
        self.train_x, self.train_y = self._gen(rng, self.n_train)
        self.test_x, self.test_y = self._gen(rng, self.n_test)

    def _gen(self, rng, n):
        cls = rng.integers(0, self.n_classes, n)
        seqs = np.zeros((n, self.seq_len), np.int32)
        tok = rng.integers(0, self.vocab, n)
        for t in range(self.seq_len):
            seqs[:, t] = tok
            cum = np.cumsum(self.trans[cls, tok], axis=-1)
            tok = (cum > rng.random((n, 1))).argmax(-1)
        return seqs, cls.astype(np.int32)

    @property
    def kind(self):
        return "lm"


def make_dataset(name: str, **kw):
    name = name.lower()
    if name in ("cifar10", "images", "synthetic-cifar"):
        return SyntheticImages(**kw)
    if name in ("cifar10-hard", "teacher"):
        kw.pop("sigma", None)
        return TeacherImages(**kw)
    if name in ("celeba", "celeba-like"):
        kw.setdefault("n_classes", 2)
        kw.setdefault("shape", (32, 32, 3))
        return SyntheticImages(**kw)
    if name in ("lm", "tokens"):
        return SyntheticLM(**kw)
    raise ValueError(f"unknown dataset {name!r}")
