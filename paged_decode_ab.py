"""Paged-decode kernel (K4) A/B of checkouts of the PyTorch port on one card.

Run from the root of a checkout on a machine with a card and the CUDA
toolkit::

    python3 paged_decode_ab.py DIR_A DIR_B [--rounds 1]

Each DIR is the root of a checkout. Per round, in the order A, B, B, A, a
fresh process puts DIR's package first on its path, so it builds DIR's
``paged_decode.cu`` (into DIR's ``build/``, with ptxas's registers and
spills, printed once per DIR) and launches it through DIR's own wrapper.
It times K4 with this checkout's ``chip_smoke.time_paged`` at the three
shapes of ``chip_smoke.PAGED_TIMING`` (bf16, the same seeded inputs for
every DIR): device time from a CUDA graph of the wrapper's calls, the
same calls launched eagerly, the plain version's time, the SDPA
yardstick's and the bound; and it holds one more seeded case of each
shape against the plain version. It prints one line per run and each
DIR's median ms per shape. Compare versions only within one such call:
calls land on different machines.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

_RUN = """
import importlib.util, json, sys, torch
root, tree = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("smoke", root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
assert cs.tatt.__file__.startswith(tree), cs.tatt.__file__
cs.device_line()
cs._kernels.build(["paged_decode"], extra_flags=("-Xptxas", "-v"))
gen = torch.Generator(device=cs.DEV).manual_seed(0)
out = {}
for name, shape in cs.PAGED_TIMING.items():
    out[name] = cs.time_paged(gen, shape)
    case = cs.paged_case(gen, dtype=torch.bfloat16, **shape)
    out[name]["max_abs_err"] = cs.compare(case, None)
print("RESULT " + json.dumps(out))
"""


def ptxas_report(log: str) -> list:
    """``kernel<template args>: N regs, spill S+L`` per compiled K4 kernel,
    from ``-Xptxas -v`` output."""
    out, name, spill = [], "?", "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?\d(paged_decode_[a-z]+_"
                      r"kernel)I(.*?)EEv", line)
        if m:
            name = f"{m.group(1)}<{m.group(2).rstrip('E')}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}+{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} regs, spill {spill}")
    return out


def run_once(tree: pathlib.Path) -> tuple:
    """One timing process for ``tree``: ``(results, ptxas report)``."""
    proc = subprocess.run([sys.executable, "-c", _RUN, str(ROOT), str(tree)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(f"K4 run of {tree} failed:\n{proc.stderr[-4000:]}")
    result = json.loads(next(line for line in proc.stdout.splitlines()
                             if line.startswith("RESULT "))[7:])
    return result, ptxas_report(proc.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", type=pathlib.Path, nargs=2)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    trees = {"A": args.dirs[0].resolve(), "B": args.dirs[1].resolve()}
    runs = {"A": [], "B": []}
    for _ in range(args.rounds):
        for label in ("A", "B", "B", "A"):
            result, ptxas = run_once(trees[label])
            if not runs[label]:
                for line in ptxas:
                    print(f"{label} ptxas {line}", flush=True)
            runs[label].append(result)
            print(f"{label} {trees[label]} " + " ".join(
                f"{name}:ms={r['ms']:.5f},eager_ms={r['eager_ms']:.5f},"
                f"plain_ms={r['plain_ms']:.5f},"
                f"library_ms={r['library_ms']:.5f},"
                f"bound_ms={r['bound_ms']:.5f},err={r['max_abs_err']:.3g}"
                for name, r in result.items()), flush=True)
    for label, results in runs.items():
        print(f"{label} median_ms " + " ".join(
            f"{name}={statistics.median(r[name]['ms'] for r in results):.5f}"
            for name in results[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
