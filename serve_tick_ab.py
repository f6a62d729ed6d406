"""Serve-tick A/B of two checkouts of the PyTorch port on one card.

Run from anywhere on a machine with a card and the CUDA toolkit::

    python3 serve_tick_ab.py DIR_A DIR_B [--rounds 2]

Each DIR is the root of a checkout (with its own ``chip_smoke.py``). Per
round the script runs the engine-serve phase of each checkout's
``chip_smoke.py`` (full-width Llama-1B in bf16, 24 requests of 384 prompt
tokens x 32 new tokens on 8 slots) in the order A, B, B, A, every run in
a fresh process started in that checkout, so each imports its own
package and builds its own kernels. It prints each run's ``[engine_serve]``
line prefixed by its label, then the median decode-tick p50 and tokens/s
of each side. Compare two versions only within one such call: calls land
on different machines.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

import numpy as np

_RUN = ("import chip_smoke as c\n"
        "c.device_line()\n"
        "c.build_kernels()\n"
        "c.phase_engine_serve()\n")


def serve_once(root: pathlib.Path) -> str:
    """One engine-serve phase from ``root``; returns its phase line."""
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"serve run in {root} failed:\n{out.stderr[-4000:]}")
    return next(line for line in out.stdout.splitlines()
                if line.startswith("[engine_serve]"))


def field(line: str, key: str) -> float:
    return float(re.search(rf"\b{key}=(\S+)", line).group(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", type=pathlib.Path)
    ap.add_argument("b", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    lines = {"A": [], "B": []}
    for _ in range(args.rounds):
        for label in ("A", "B", "B", "A"):
            line = serve_once(getattr(args, label.lower()).resolve())
            print(f"{label} {line}", flush=True)
            lines[label].append(line)
    for label, runs in lines.items():
        ticks = [field(x, "decode_tick_ms_p50") for x in runs]
        rates = [field(x, "tokens_per_s") for x in runs]
        print(f"{label} median decode_tick_ms_p50={np.median(ticks):.4f} "
              f"tokens_per_s={np.median(rates):.2f} runs={len(runs)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
