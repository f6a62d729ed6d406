"""Synthetic language-modeling data: deterministic, host-cheap (the port's
copy of :class:`pddl_tpu.data.synthetic.SyntheticLanguageModeling`, batch
for batch identical: numpy only, one seed per (seed, batch index)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


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
