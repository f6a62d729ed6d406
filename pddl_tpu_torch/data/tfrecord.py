"""TFRecord IO: native C++ reader bindings + pure-Python writer/fallback
(the port of :mod:`pddl_tpu.data.tfrecord`: the same framing, the same C++
reader, so the two packages read the same records in the same order).

The reference's ImageNet pipeline reads TFDS-prepared TFRecord shards
through TensorFlow's C++ tf.data runtime (SURVEY.md §2b C15 —
``imagenet-resnet50.py:20-34``). This module is the framework's own
record layer for that format:

- :class:`TFRecordReader` — ctypes binding to ``csrc/pddl_tfrecord.cpp``
  (built into the native loader's library, ``native_loader.py``, at the
  first use): CRC-validated indexing, per-process sharding, deterministic
  per-epoch shuffling, and a prefetching reader thread. Yields raw record
  payloads (``bytes``); decode (tf.Example, JPEG) happens above, exactly
  as ``tf.data.TFRecordDataset`` is decode-agnostic.
- :func:`write_tfrecord` / :func:`read_tfrecord` — dependency-free Python
  implementations of the framing (u64 length | u32 masked-crc32c(length) |
  payload | u32 masked-crc32c(payload)), used for packing, tests, and as a
  no-native fallback. Byte-compatible with TF's writer/reader.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterable, Iterator, List, Optional, Sequence

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) + TFRecord masking, pure Python.

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (0x82F63B78 ^ (_c >> 1)) if (_c & 1) else (_c >> 1)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset CRC mask."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Pure-Python framing.


def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    """Write ``records`` in TFRecord framing; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
            n += 1
    return n


def read_tfrecord(path: str, verify: bool = True) -> Iterator[bytes]:
    """Sequentially yield record payloads (Python fallback reader)."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if not hdr:
                return
            if len(hdr) != 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", hdr[:8])
            (length_crc,) = struct.unpack("<I", hdr[8:])
            if verify and masked_crc32c(hdr[:8]) != length_crc:
                raise IOError(f"{path}: corrupt record length CRC")
            payload = f.read(length)
            footer = f.read(4)
            if len(payload) != length or len(footer) != 4:
                raise IOError(f"{path}: truncated record payload")
            if verify and masked_crc32c(payload) != struct.unpack("<I", footer)[0]:
                raise IOError(f"{path}: payload CRC mismatch")
            yield payload


def count_records(path: str) -> int:
    """Record count by hopping frame lengths (no payload reads/CRCs)."""
    n = 0
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if not hdr:
                return n
            if len(hdr) != 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", hdr[:8])
            f.seek(length + 4, 1)
            n += 1


# ---------------------------------------------------------------------------
# Native reader binding.

_proto_ready = False


def _tfr_lib():
    """The shared native library with pddl_tfr_* prototypes registered."""
    from pddl_tpu_torch.data.native_loader import _load_lib

    # Built from the sources in csrc/ (named by their digest), so the
    # pddl_tfr_* symbols are always there; a failed build raises.
    lib = _load_lib()
    global _proto_ready
    if not _proto_ready:
        lib.pddl_tfr_open.restype = ctypes.c_void_p
        lib.pddl_tfr_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        for fn in (lib.pddl_tfr_count, lib.pddl_tfr_total_count,
                   lib.pddl_tfr_max_length):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p]
        lib.pddl_tfr_next.restype = ctypes.c_long
        lib.pddl_tfr_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ]
        lib.pddl_tfr_reset.argtypes = [ctypes.c_void_p]
        lib.pddl_tfr_close.argtypes = [ctypes.c_void_p]
        lib.pddl_crc32c.restype = ctypes.c_uint32
        lib.pddl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.pddl_masked_crc32c.restype = ctypes.c_uint32
        lib.pddl_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_long]
        _proto_ready = True
    return lib


def native_crc32c(data: bytes) -> int:
    """CRC32C computed by the native library (for parity tests)."""
    return _tfr_lib().pddl_crc32c(data, len(data))


def native_masked_crc32c(data: bytes) -> int:
    return _tfr_lib().pddl_masked_crc32c(data, len(data))


class TFRecordReader:
    """Re-iterable raw-record source backed by the C++ runtime.

    Each ``iter()`` yields one epoch of payload ``bytes`` in this shard's
    (optionally shuffled) order; shuffling reseeds deterministically per
    epoch. ``shard_index/shard_count`` shard the *global* record sequence
    across processes, every ``shard_count``-th record (the DATA auto-shard
    analogue, ``imagenet-resnet50-multiworkers.py:66-69``).

    Opening validates the framing of every record's length field; payload
    CRCs are checked on read while ``verify=True``. Corrupt files fail at
    construction or raise mid-iteration — never yield garbage.
    """

    def __init__(self, paths: Sequence[str], *, shuffle: bool = False,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1,
                 verify: bool = True, prefetch_depth: int = 16):
        self._handle = None
        self._lib = _tfr_lib()
        arr = (ctypes.c_char_p * len(paths))(
            *[os.fsencode(p) for p in paths])
        self._handle = self._lib.pddl_tfr_open(
            arr, len(paths), int(shuffle), seed, shard_index, shard_count,
            int(verify), prefetch_depth,
        )
        if not self._handle:
            raise FileNotFoundError(
                f"TFRecordReader failed to open {list(paths)} (missing file, "
                "corrupt framing, or empty shard)"
            )
        self._paths = list(paths)
        self._first_epoch = True

    @property
    def num_records(self) -> int:
        """Records in THIS shard."""
        return self._lib.pddl_tfr_count(self._handle)

    @property
    def total_records(self) -> int:
        """Records across all shards (the full file set)."""
        return self._lib.pddl_tfr_total_count(self._handle)

    def __len__(self) -> int:
        return self.num_records

    def __iter__(self) -> Iterator[bytes]:
        if self._handle is None:
            raise RuntimeError("reader is closed")
        if not self._first_epoch:
            self._lib.pddl_tfr_reset(self._handle)
        self._first_epoch = False
        cap = max(1, self._lib.pddl_tfr_max_length(self._handle))
        buf = (ctypes.c_uint8 * cap)()
        while True:
            if self._handle is None:  # close()d mid-iteration
                raise RuntimeError("reader is closed")
            n = self._lib.pddl_tfr_next(self._handle, buf, cap)
            if n == -4:  # end of epoch (0 is a legal empty record)
                return
            if n < 0:
                if n == -1:
                    raise RuntimeError("reader closed during iteration")
                raise IOError(
                    f"TFRecord read error ({'short buffer' if n == -2 else 'payload CRC/read failure'}) "
                    f"in {self._paths}"
                )
            yield ctypes.string_at(buf, n)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.pddl_tfr_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def open_tfrecords(paths: Sequence[str], *, native: Optional[bool] = None,
                   **kwargs):
    """Best reader available: native if built (or buildable), else Python.

    With ``native=None`` (auto) the library is built on first use when a
    toolchain is present (like :class:`NativeLoader`), falling back to the
    sequential Python reader only when it is genuinely unbuildable; the
    fallback supports just the no-shuffle single-shard case. Forcing
    ``native=True`` raises if the library can't be built.
    """
    if native is None:
        try:
            _tfr_lib()  # builds on first use; raises if it cannot
            native = True
        except (RuntimeError, OSError):
            native = False
    if native:
        return TFRecordReader(paths, **kwargs)
    if kwargs.get("shuffle") or kwargs.get("shard_count", 1) != 1:
        raise RuntimeError(
            "python TFRecord fallback is sequential/unsharded; the "
            "native library (data/csrc/, built at first use) is needed "
            "for shuffle/sharding"
        )

    class _PyReader:
        """Sequential fallback with the TFRecordReader surface."""

        def __iter__(self):
            for p in paths:
                yield from read_tfrecord(p, verify=kwargs.get("verify", True))

        _count = None

        @property
        def num_records(self):
            # Counted once, by frame-length seeks only — len() must not
            # cost a full verified dataset scan.
            if self._count is None:
                self._count = sum(count_records(p) for p in paths)
            return self._count

        total_records = num_records

        def __len__(self):
            return self.num_records

        def close(self):
            pass

    return _PyReader()
