"""Flash-backward kernel A/B of checkouts of the PyTorch port on one card.

Run from the root of a checkout on a machine with a card and the CUDA
toolkit::

    python3 flash_bwd_ab.py DIR_A DIR_B [DIR_C ...] [--rounds 2]

Each DIR is the root of a checkout whose ``flash_bwd.cu`` has this
checkout's C entries. The script compiles each DIR's
``pddl_tpu_torch/ops/csrc/flash_bwd.cu`` (with that DIR's headers) by
``nvcc`` into ``build/ab/`` here, all in parallel, printing ptxas's
registers and spills, loads them, and times them through this checkout's
wrappers on CUDA events: K2 and K3b at Llama-1B's training shape (B 4,
H 32/8, S 2048, D 64, bf16, causal), and K2, K3a and K3b at its long
shape (B 1, S 8192), in the order A, B, ..., ..., B, A per round. It
prints one line per timed run, each tree's median per kernel, and how far
each tree's gradients are from A's at both shapes (relative to A's
max-abs). Compare versions only within one such call: calls land on
different machines.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import string
import subprocess

import torch

import chip_smoke as cs
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt

KERNELS = ("k2_s2048", "k3b_s2048", "k2_s8192", "k3a_s8192", "k3b_s8192")


def ptxas_report(log: str) -> list:
    """``kernel<args>: N regs, S spill bytes`` per compiled kernel, from
    ``-Xptxas -v`` output."""
    out, name, spill = [], "?", "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?\d(flash_bwd_[a-z0-9_]+"
                      r"kernel)(ILi\d+E(?:Lb[01])?)?", line)
        if m:
            name = m.group(1) + (m.group(2) or "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}+{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} regs, spill {spill}")
    return out


def build(dirs: dict) -> dict:
    """``label -> loaded library`` of each DIR's flash_bwd.cu, compiled in
    parallel; raises with nvcc's output if a build fails."""
    out_dir = _kernels.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, root in dirs.items():
        src = root / "pddl_tpu_torch" / "ops" / "csrc" / "flash_bwd.cu"
        lib = out_dir / f"libflash_bwd_{label}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(lib), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        print(f"[nvcc {label}] " + "; ".join(ptxas_report(log)), flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {label} exited {proc.returncode}\n{log}")
        libs[label] = ctypes.CDLL(str(lib))
        _kernels._bind("flash_bwd", libs[label])
    return libs


def inputs(gen, shape):
    """Two input sets at ``shape``: ``(q, k, v), o, lse, do, di`` each."""
    sets = []
    for _ in range(2):
        qkv, do, _, kw = cs.flash_case(gen, *shape)
        o, lse = tatt.flash_forward(*qkv, **kw)
        sets.append((qkv, o, lse, do, tatt._row_term(o, do)))
    return sets, kw


def time_once(short, short_kw, long, long_kw) -> dict:
    """Each kernel's mean ms over 10 launches, cycling over two sets."""
    def k2(sets, kw):
        return lambda i: tatt.flash_backward(*sets[i][0], *sets[i][1:4], **kw)
    def k3b(sets, kw):
        return lambda i: tatt.flash_backward_dkv(
            *sets[i][0], sets[i][3], sets[i][2], sets[i][4], **kw)
    ms = {"k2_s2048": cs.cuda_ms(k2(short, short_kw), 2, iters=10),
          "k3b_s2048": cs.cuda_ms(k3b(short, short_kw), 2, iters=10)}
    with cs.dispatch_threshold(1 << 62):
        ms["k2_s8192"] = cs.cuda_ms(k2(long, long_kw), 2, iters=10)
    ms["k3a_s8192"] = cs.cuda_ms(lambda i: tatt.flash_backward_dq(
        *long[i][0], long[i][3], long[i][2], long[i][4], **long_kw), 2,
        iters=10)
    ms["k3b_s8192"] = cs.cuda_ms(k3b(long, long_kw), 2, iters=10)
    return ms


def grads(short, short_kw, long, long_kw):
    """K2's gradients at S 2048 and K3's at S 8192, on the first set."""
    s, lg = short[0], long[0]
    return (tatt.flash_backward(*s[0], *s[1:4], **short_kw),
            tatt.flash_backward(*lg[0], *lg[1:4], **long_kw))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", type=pathlib.Path, nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not 2 <= len(args.dirs) <= 26:
        ap.error("give 2 to 26 checkouts")
    labels = string.ascii_uppercase[:len(args.dirs)]
    print(cs.device_line(), flush=True)
    libs = build({label: d.resolve() for label, d in zip(labels, args.dirs)})
    gen = torch.Generator(device=cs.DEV).manual_seed(7)
    short, short_kw = inputs(gen, cs.FLASH_CASES["llama1b"])
    long, long_kw = inputs(gen, cs.LONG)
    got, runs = {}, {label: [] for label in labels}
    for label, lib in libs.items():
        _kernels._libs["flash_bwd"] = lib
        got[label] = grads(short, short_kw, long, long_kw)
    torch.cuda.synchronize()
    for _ in range(args.rounds):
        for label in labels + labels[::-1]:
            _kernels._libs["flash_bwd"] = libs[label]
            ms = time_once(short, short_kw, long, long_kw)
            runs[label].append(ms)
            print(label, " ".join(f"{k}_ms={v:.5f}" for k, v in ms.items()),
                  flush=True)
    for label, ms in runs.items():
        print(f"median {label}", " ".join(
            f"{k}_ms={statistics.median(m[k] for m in ms):.5f}"
            for k in KERNELS), flush=True)
    for label in labels[1:]:
        for i, shape in enumerate(("s2048_k2", "s8192_k3")):
            rel = cs.rel_errs(got[label][i], got["A"][i])
            print(f"{label}_vs_A {shape} dq={rel[0]:.3g} dk={rel[1]:.3g} "
                  f"dv={rel[2]:.3g}", flush=True)
    _kernels._libs.pop("flash_bwd", None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
