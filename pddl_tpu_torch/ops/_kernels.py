"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/`` at the
root of the checkout (listed in ``.gitignore``) the first time it is
used, and loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds. The flash kernels share device helpers in
``csrc/flash_common.cuh``. The library's file name carries a hash of its
source and of every shared header, so an edited kernel or header is
rebuilt and a stale library is never loaded. The sources in the checkout
are the build's only input.

Nothing here runs at import: the CPU tests import every module of the
port on a host without ``nvcc``. Launch counts live in
:data:`launch_counts`, one per kernel variant (:data:`COUNTERS`) — each
wrapper adds one where it launches its kernel, and nowhere else, so a run
can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# name -> source file under csrc/
SOURCES = {"paged_decode": "paged_decode.cu", "flash_fwd": "flash_fwd.cu",
           "flash_bwd": "flash_bwd.cu"}

# Launch counters: one per kernel variant a run may go through. The
# forward's two variants (with and without the LSE write) share a source,
# and so do the backward's three (the fused K2, the two-sweep K3a and K3b).
COUNTERS = ("paged_decode", "flash_fwd", "flash_fwd_nolse", "flash_bwd_fused",
            "flash_bwd_dq", "flash_bwd_dkv")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches per kernel since the last reset_launch_counts().
launch_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_DEFAULT_NVCC):
        return _DEFAULT_NVCC
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels build on a host with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, every
    shared header under ``csrc/`` (``*.cuh``) and the flags: an edit to any
    of them names a new library, which :func:`build` compiles."""
    digest = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None,
          extra_flags: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing — one ``nvcc``
    per source, all started together — and return ``name -> library``.
    Raises with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = {}
    for name in names:
        lib = _lib_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if log.strip():
            # To stderr: a fleet worker's stdout carries its protocol only.
            print(f"[nvcc {name}]\n{log.rstrip()}", file=sys.stderr)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _bind(name, lib)
        _libs[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "paged_decode":
        lib.pddl_paged_decode.argtypes = [
            p, p, p, p, p, p,            # q, k_pool, v_pool, table, index, out
            p,                           # scratch (NULL with one split)
            i, i, i, i, i, i, i,         # B, H, Hkv, N, bs, D, T
            i, ctypes.c_float,           # window, scale
            i, i, i, p]                  # n_split, per_split, dtype, stream
        lib.pddl_paged_decode.restype = i
    elif name == "flash_fwd":
        lib.pddl_flash_fwd.argtypes = [
            p, p, p, p, p,               # q, k, v, o, lse (NULL: no LSE)
            i, i, i, i, i, i,            # B, H, Hkv, Sq, Sk, D
            i, i, i, ctypes.c_float,     # causal, window, k_offset, scale
            i, p]                        # dtype, stream
        lib.pddl_flash_fwd.restype = i
    elif name == "flash_bwd":
        lib.pddl_flash_bwd.argtypes = [
            p, p, p, p, p, p,            # q, k, v, do, lse, di
            p, p, p,                     # dq (f32), dk, dv
            i, i, i, i, i, i,            # B, H, Hkv, Sq, Sk, D
            i, i, i, ctypes.c_float,     # causal, window, k_offset, scale
            i, p]                        # dtype, stream
        lib.pddl_flash_bwd.restype = i
        lib.pddl_flash_bwd_dq.argtypes = [
            p, p, p, p, p, p,            # q, k, v, do, lse, di
            p,                           # dq (q's type)
            i, i, i, i, i, i,            # B, H, Hkv, Sq, Sk, D
            i, i, i, ctypes.c_float,     # causal, window, k_offset, scale
            i, p]                        # dtype, stream
        lib.pddl_flash_bwd_dq.restype = i
        lib.pddl_flash_bwd_dkv.argtypes = [
            p, p, p, p, p, p,            # q, k, v, do, lse, di
            p, p,                        # dk, dv
            i, i, i, i, i, i,            # B, H, Hkv, Sq, Sk, D
            i, i, i, ctypes.c_float,     # causal, window, k_offset, scale
            i, p]                        # dtype, stream
        lib.pddl_flash_bwd_dkv.restype = i
    lib.pddl_cuda_error_string.argtypes = [i]
    lib.pddl_cuda_error_string.restype = ctypes.c_char_p


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code != 0:
        msg = library(name).pddl_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
