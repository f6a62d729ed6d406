"""Token-corpus pipeline for the language-model family (the port of
:mod:`pddl_tpu.data.text`: numpy only, the same files, windows, shuffles
and shards, so the two packages give the same batches).

The reference is image-only (ResNet-50/ImageNet, SURVEY.md §0); the GPT
and Llama families here (``pddl_tpu_torch/models/``) are beyond-parity,
and this module gives them a real data path mirroring the ImageNet
design: one-time preparation to a compact binary format, then
memory-mapped, shuffled, per-process-sharded batch iteration with zero
per-epoch decode cost.

Format: a flat little-endian ``uint16`` token file (``train.bin`` /
``val.bin``) plus a ``meta.json`` sidecar recording ``vocab_size`` — the
same shape of artifact the packed image loader uses (PDL1), chosen over
raw text so epochs are pure ``memmap`` slicing.

Preparation is byte-level by default (vocab 256, no external tokenizer —
nothing to download on a training host); any externally tokenized uint16
file drops in unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

META_FILE = "meta.json"


def encode_text_file(
    txt_path: str, out_path: str, *, vocab: str = "byte"
) -> Tuple[int, int]:
    """One-time corpus preparation: text → flat uint16 token file.

    ``vocab="byte"`` maps each UTF-8 byte to its value (vocab 256).
    Returns ``(n_tokens, vocab_size)`` and writes ``meta.json`` next to
    ``out_path``.
    """
    if vocab != "byte":
        raise ValueError(f"unknown vocab {vocab!r}; only 'byte' is built in")
    out_dir = os.path.dirname(out_path) or "."
    existing = read_meta(out_dir)
    if existing and existing.get("vocab") not in (None, vocab):
        # An externally tokenized corpus lives here; byte-encoding a split
        # into it would mix token spaces and clobber its sidecar.
        raise ValueError(
            f"{out_dir}/{META_FILE} records vocab={existing.get('vocab')!r} "
            f"(size {existing.get('vocab_size')}); refusing to byte-encode "
            f"{txt_path} into the same corpus"
        )
    data = np.fromfile(txt_path, dtype=np.uint8)
    # Atomic publish: every process of a multi-host job runs preparation
    # concurrently (run.py build_data); os.replace means no reader ever
    # memmaps a half-written file, and identical writers race harmlessly.
    tmp = f"{out_path}.tmp.{os.getpid()}"
    data.astype("<u2").tofile(tmp)
    os.replace(tmp, out_path)

    split = os.path.basename(out_path).rsplit(".", 1)[0]
    meta = existing or {"vocab_size": 256, "vocab": vocab, "n_tokens": {}}
    if not isinstance(meta.get("n_tokens"), dict):  # legacy scalar field
        meta["n_tokens"] = {}
    meta["n_tokens"][split] = int(data.size)
    meta_tmp = os.path.join(out_dir, f"{META_FILE}.tmp.{os.getpid()}")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(meta_tmp, os.path.join(out_dir, META_FILE))
    return int(data.size), 256


def read_meta(data_dir: str) -> Optional[dict]:
    path = os.path.join(data_dir, META_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class TokenFileDataset:
    """Re-iterable ``{"tokens": i32[B,S], "targets": i32[B,S]}`` batches
    (host numpy; ``Trainer`` moves them to the device).

    The file is memory-mapped; an epoch is the deterministic (seeded,
    reshuffled per epoch) order of non-overlapping ``seq_len``-token
    windows, sharded every ``process_count``-th window per process — the
    LM analogue of the image pipelines' DATA sharding. Targets are the
    next-token shift of the window.
    """

    path: str
    batch_size: int  # GLOBAL batch; each process yields its share
    seq_len: int = 64
    shuffle: bool = True
    seed: int = 0
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        if self.batch_size % self.process_count:
            raise ValueError(
                f"batch {self.batch_size} not divisible by "
                f"{self.process_count} processes"
            )
        self._tokens = np.memmap(self.path, dtype="<u2", mode="r")
        # +1: every window needs its successor token for the target shift.
        self._n_windows = (len(self._tokens) - 1) // self.seq_len
        if self._n_windows < 1:
            raise ValueError(
                f"{self.path}: {len(self._tokens)} tokens is shorter than "
                f"one {self.seq_len}-token window"
            )
        self._epoch = 0

    @property
    def local_batch_size(self) -> int:
        return self.batch_size // self.process_count

    @property
    def batches_per_epoch(self) -> int:
        # Floor computed GLOBALLY (smallest shard's share): every process
        # must run the same number of steps per epoch or the job
        # deadlocks in a collective at epoch end.
        return (self._n_windows // self.process_count) // self.local_batch_size

    def max_token(self) -> int:
        """Largest token id in the file (vocab bound for meta-less .bins)."""
        return int(self._tokens.max()) if len(self._tokens) else 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self._n_windows)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        self._epoch += 1
        mine = order[self.process_index::self.process_count]
        lb, S = self.local_batch_size, self.seq_len
        offsets = np.arange(S + 1)
        for i in range(self.batches_per_epoch):
            idxs = mine[i * lb:(i + 1) * lb]
            # One vectorized gather per batch (no per-row Python loop).
            chunks = self._tokens[idxs[:, None] * S + offsets].astype(np.int32)
            yield {"tokens": chunks[:, :-1], "targets": chunks[:, 1:]}


def load_token_corpus(
    data_dir: str,
    *,
    seq_len: int,
    train_batch_size: int,
    val_batch_size: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Tuple[TokenFileDataset, TokenFileDataset]:
    """Train/val datasets from a corpus directory.

    Accepts either prepared ``train.bin``/``val.bin`` (+ ``meta.json``),
    or raw ``train.txt``/``val.txt`` which are byte-encoded once and
    cached as ``.bin``. A ``val``-less corpus reuses the train file for
    validation — the "val" metrics are then training-set metrics (all
    windows, file order); provide ``val.txt``/``val.bin`` for a real
    held-out split.
    """
    def _ensure(split: str) -> Optional[str]:
        bin_path = os.path.join(data_dir, f"{split}.bin")
        if os.path.exists(bin_path):
            return bin_path
        txt_path = os.path.join(data_dir, f"{split}.txt")
        if os.path.exists(txt_path):
            encode_text_file(txt_path, bin_path)
            return bin_path
        return None

    train_path = _ensure("train")
    if train_path is None:
        raise FileNotFoundError(
            f"no train.bin or train.txt under {data_dir!r} (LM corpora are "
            "a flat uint16 token file; see pddl_tpu_torch.data.text)"
        )
    val_path = _ensure("val") or train_path
    common = dict(seq_len=seq_len, seed=seed, process_index=process_index,
                  process_count=process_count)
    return (
        TokenFileDataset(train_path, batch_size=train_batch_size, **common),
        TokenFileDataset(val_path, batch_size=val_batch_size, shuffle=False,
                         **{**common, "seed": seed + 1}),
    )
