"""The native C++ data loader (the port of :mod:`pddl_tpu.data.native_loader`).

``csrc/pddl_io.cpp`` is a threaded, ring-buffered, deterministic batch
loader for a packed uint8 sample format (PDL1), bound here with ctypes. It
is the port's own copy of the JAX package's source, so the two give the
same batches for the same file and seed. The reference's input pipeline
runs inside TensorFlow's C++ tf.data runtime; this is the counterpart.

Workflow::

    # once: pack any image source (per host shard for ImageNet)
    write_packed(path, images_uint8, labels)
    # training: C++ threads read, batch and prefetch; Python consumes
    trainer.fit(NativeLoader([path], batch_size=256, num_workers=4))

Batches are ``{"image": uint8 [B, H, W, C], "label": int32 [B]}`` numpy
arrays. ``Trainer`` moves them to the card (with ``fit(prefetch=)``
through pinned memory on a side stream), and the model casts on the
device.

**The library** is compiled from ``csrc/`` by the host compiler (``$CXX``
or ``g++``, with the JAX package's Makefile flags) at the first use, into
``build/`` at the root of the checkout, named by a digest of the sources,
the compiler and the flags: an edited source builds a new library, and a
stale one is never loaded. A failed build raises with the compiler's
output; there is no prebuilt fallback. The build writes a temporary file
and renames it into place, so processes building at once do not race.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import struct
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

from pddl_tpu_torch.ops._kernels import BUILD_DIR

_MAGIC = 0x314C4450  # "PDL1"
_HEADER = struct.Struct("<IIHHHH")

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("pddl_io.cpp",)
_HEADERS = ("pddl_rng.h",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

_lib = None


def _compiler() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


def library_path() -> Path:
    """The library for the sources in ``csrc/`` (built or not)."""
    digest = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        digest.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
    digest.update(" ".join(_compiler() + list(CXX_FLAGS)).encode())
    return BUILD_DIR / f"libpddl_io-{digest.hexdigest()[:12]}.so"


def _build() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"native loader build failed: no compiler {cmd[0]!r} ($CXX or "
            "g++)") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native loader build failed ({' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stderr.strip()}")
    os.replace(tmp, lib)
    return lib


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))  # RTLD_LOCAL: the JAX copy may be loaded
    lib.pddl_loader_open.restype = ctypes.c_void_p
    lib.pddl_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pddl_loader_shape.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.pddl_loader_num_samples.restype = ctypes.c_long
    lib.pddl_loader_num_samples.argtypes = [ctypes.c_void_p]
    lib.pddl_loader_batches_per_epoch.restype = ctypes.c_long
    lib.pddl_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.pddl_loader_next.restype = ctypes.c_int
    lib.pddl_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pddl_loader_reset.argtypes = [ctypes.c_void_p]
    lib.pddl_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def build_native() -> Path:
    """Build (if needed) and load the library; return its path."""
    _load_lib()
    return library_path()


def native_available() -> bool:
    """True iff the library for the current sources is built. Loads
    nothing."""
    return library_path().exists()


class PackedWriter:
    """Streaming PDL1 writer: append samples one by one; the count is
    patched on close (so converters need not know N up front)."""

    def __init__(self, path: str, height: int, width: int, channels: int):
        self.shape = (height, width, channels)
        self._f = open(path, "wb")
        self._n = 0
        self._f.write(_HEADER.pack(_MAGIC, 0, height, width, channels, 0))

    def add(self, image: np.ndarray, label: int) -> None:
        image = np.ascontiguousarray(image, np.uint8)
        if image.shape != self.shape:
            raise ValueError(f"sample shape {image.shape} != {self.shape}")
        self._f.write(struct.pack("<i", int(label)))
        self._f.write(image.tobytes())
        self._n += 1

    def close(self) -> int:
        if self._f is None:
            return self._n
        self._f.seek(4)
        self._f.write(struct.pack("<I", self._n))
        self._f.close()
        self._f = None
        return self._n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_packed(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Write samples in the PDL1 packed format.

    ``images``: uint8 [N, H, W, C]; ``labels``: int [N].
    """
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.asarray(labels, np.int32)
    if images.ndim != 4 or len(labels) != len(images):
        raise ValueError(f"bad shapes {images.shape} / {labels.shape}")
    n, h, w, c = images.shape
    with PackedWriter(path, h, w, c) as w_:
        for i in range(n):
            w_.add(images[i], int(labels[i]))


class NativeLoader:
    """Re-iterable batch source backed by the C++ runtime.

    Yields ``{"image": [B, H, W, C], "label": int32 [B]}``, which
    ``Trainer.fit`` takes. Images stay **uint8** by default (4x less host
    memory and host-to-device traffic than f32; the model casts on the
    device); ``dtype="float32"`` casts on the host. ``shard_index`` and
    ``shard_count`` give each process every ``shard_count``-th sample.
    Iterating again starts the next epoch (a reshuffle). With one worker
    the batch order is a function of the seed; with several, each epoch
    holds the same samples in an order that depends on the threads.
    :meth:`close` (or leaving a ``with`` block) stops the threads.
    """

    def __init__(self, paths: Sequence[str], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1,
                 prefetch_depth: int = 4, num_workers: int = 2,
                 drop_remainder: bool = True, dtype: str = "uint8"):
        self._handle = None
        self._lib = _load_lib()
        arr = (ctypes.c_char_p * len(paths))(
            *[os.fsencode(p) for p in paths])
        self._handle = self._lib.pddl_loader_open(
            arr, len(paths), batch_size, int(shuffle), seed, shard_index,
            shard_count, prefetch_depth, num_workers, int(drop_remainder), 0,
        )
        if not self._handle:
            raise FileNotFoundError(
                f"native loader failed to open {list(paths)} (missing files, "
                "bad magic, or heterogeneous shapes)"
            )
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._lib.pddl_loader_shape(self._handle, ctypes.byref(h),
                                    ctypes.byref(w), ctypes.byref(c))
        self.image_shape = (h.value, w.value, c.value)
        self.batch_size = batch_size
        self.dtype = dtype
        self._first_epoch = True

    @property
    def num_samples(self) -> int:
        return self._lib.pddl_loader_num_samples(self._handle)

    @property
    def batches_per_epoch(self) -> int:
        return self._lib.pddl_loader_batches_per_epoch(self._handle)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._handle is None:
            raise RuntimeError("loader is closed")
        if not self._first_epoch:
            self._lib.pddl_loader_reset(self._handle)
        self._first_epoch = False
        h, w, c = self.image_shape
        images = np.empty((self.batch_size, h, w, c), np.uint8)
        labels = np.empty((self.batch_size,), np.int32)
        img_ptr = images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        lbl_ptr = labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            if self._handle is None:  # close()d mid-iteration
                raise RuntimeError("loader is closed")
            n = self._lib.pddl_loader_next(self._handle, img_ptr, lbl_ptr)
            if n <= 0:
                return
            yield {
                "image": images[:n].astype(self.dtype),
                "label": labels[:n].copy(),
            }

    def close(self) -> None:
        if self._handle is not None:
            self._lib.pddl_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
