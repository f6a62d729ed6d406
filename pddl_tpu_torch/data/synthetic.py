"""Synthetic data: deterministic, host-cheap (the port's copies of
:class:`pddl_tpu.data.synthetic.SyntheticImageClassification` and
:class:`~pddl_tpu.data.synthetic.SyntheticLanguageModeling`, batch for
batch identical: numpy only, one seed per (seed, batch index))."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticImageClassification:
    """Infinite iterable of ``{"image": f32[B,H,W,C], "label": i32[B]}``.

    Each class has a distinct per-channel mean (drawn from ``seed``), so a
    model can fit the data; ``signal_strength`` scales the separation (0
    is pure noise). ``process_index``/``process_count`` slice this
    process's share of the global batch, and ``index_offset`` shifts the
    batch-index space (a validation split with the same class means).
    """

    batch_size: int = 32
    image_size: int = 224
    channels: int = 3
    num_classes: int = 1000
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    signal_strength: float = 1.0
    index_offset: int = 0

    def __post_init__(self):
        if self.batch_size % self.process_count:
            raise ValueError(
                f"batch {self.batch_size} not divisible by "
                f"{self.process_count} processes")
        self._class_means = None

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    def _means(self) -> np.ndarray:
        if self._class_means is None:
            rng = np.random.default_rng(self.seed)
            self._class_means = rng.normal(
                size=(self.num_classes, self.channels)).astype(np.float32)
        return self._class_means

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Deterministic global batch ``index``, sliced to this process."""
        rng = np.random.default_rng((self.seed, index + self.index_offset))
        labels = rng.integers(0, self.num_classes, size=self.batch_size)
        images = rng.normal(size=(self.batch_size, self.image_size,
                                  self.image_size, self.channels)
                            ).astype(np.float32)
        if self.signal_strength:
            images += (self.signal_strength
                       * self._means()[labels][:, None, None, :])
        lo = self.process_index * self.local_batch_size
        hi = lo + self.local_batch_size
        return {"image": images[lo:hi],
                "label": labels[lo:hi].astype(np.int32)}

    def with_offset(self, n: int) -> "SyntheticImageClassification":
        """The same stream positioned ``n`` batches ahead."""
        return dataclasses.replace(
            self, index_offset=self.index_offset + int(n))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        index = 0
        while True:
            yield self.batch(index)
            index += 1


@dataclasses.dataclass
class SyntheticLanguageModeling:
    """Infinite iterable of ``{"tokens": i32[B,S], "targets": i32[B,S]}``.

    Deterministic next-token task: sequences follow the affine recurrence
    ``t[i+1] = (a * t[i] + b) mod vocab`` (a, b drawn from ``seed``), so a
    small causal LM can drive the loss toward zero by learning the
    per-token successor map.
    """

    batch_size: int = 32
    seq_len: int = 64
    vocab_size: int = 64
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    index_offset: int = 0

    def __post_init__(self):
        if self.batch_size % self.process_count:
            raise ValueError(
                f"batch {self.batch_size} not divisible by "
                f"{self.process_count} processes")
        rng = np.random.default_rng(self.seed)
        # a coprime with vocab keeps the orbit long (more pairs to learn).
        self.a = int(rng.integers(1, self.vocab_size) * 2 + 1) % self.vocab_size or 1
        self.b = int(rng.integers(0, self.vocab_size))

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index + self.index_offset))
        start = rng.integers(0, self.vocab_size, size=self.batch_size)
        seqs = np.empty((self.batch_size, self.seq_len + 1), np.int64)
        seqs[:, 0] = start
        for i in range(self.seq_len):
            seqs[:, i + 1] = (self.a * seqs[:, i] + self.b) % self.vocab_size
        lo = self.process_index * self.local_batch_size
        hi = lo + self.local_batch_size
        return {"tokens": seqs[lo:hi, :-1].astype(np.int32),
                "targets": seqs[lo:hi, 1:].astype(np.int32)}

    def with_offset(self, n: int) -> "SyntheticLanguageModeling":
        """The same stream positioned ``n`` batches ahead."""
        return dataclasses.replace(
            self, index_offset=self.index_offset + int(n))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        index = 0
        while True:
            yield self.batch(index)
            index += 1
