"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout on a machine with a card and the CUDA
toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, drives the main paths of the
port on a full-width Llama-1B — the paged serving engine, the causal-LM
trainer, and the trainer at long context (S 8192, block remat, the
two-sweep flash backward) — and on a full-width, full-depth ResNet-50,
the reference's own workload, and prints one line per phase:

1. device — ``nvidia-smi``'s card name and power limit;
2. build — every kernel compiled by ``nvcc``, one process per source, all
   started together (seconds);
3. paged_decode vs plain — max-abs error at Llama-1B's decode shape
   (bf16 and f32, with and without a window), an odd shape (rep 3,
   D 128), the CPU tests' tiny shape, and the edges of K4's split of the
   table: depths at a split boundary and one past it, a window across
   it, a table far wider than the rows, rep 1 and rep 8, D 256 with bs
   64, table entries outside [0, N); two runs bitwise equal at the
   Llama-1B shape; then the kernel's time, the plain version's, an SDPA
   yardstick's and the bound, on CUDA events, at three shapes (mixed
   depths, the engine's steady tick, one row at depth 4095);
4. flash_fwd vs plain — K1 with and without its LSE write at Llama-1B's
   training shape (B 4, H 32/8, S 2048, D 64, bf16, causal), with a
   512 window, MHA, rep 3 at D 128, a ragged S of 1000, offset keys, f32,
   and the edges of the bf16 kernel's tiles (S 129, no mask with Sq 200 x
   Sk 136, a window of 6) and of the kv sweep's 128-key blocks (S 257,
   with and without a window of 12); two K1 runs bitwise equal (remat
   relies on it);
   then times and bound at the Llama-1B shape (SDPA the yardstick);
5. flash_bwd vs plain — K2's dq, dk, dv at the same shapes (two of them
   with an LSE cotangent too), relative to each gradient's max-abs; two K2
   runs' dk and dv bitwise equal at Llama-1B's shape; then times and bound
   (SDPA forward+backward minus forward the yardstick);
5b. flash_bwd_two_sweep vs plain — K3a's dq and K3b's dk, dv at
   Llama-1B's long shape (B 1, H 32/8, S 8192, D 64, bf16, causal: 8 MiB
   of fused dq accumulator, so the branch by the JAX package's test) and
   at K2's odd shapes with the test's threshold at 0; K3 against K2 at the
   long shape; two runs bitwise equal there: K3a's dq, K3b's and K2's dk
   and dv; then the times of K3a, K3b,
   their wrapper, K2 at the same shape, SDPA's backward and the plain
   version, K1 with and without its LSE beside SDPA's forward, and the
   bounds;
6. engine parity — full-width Llama-1B at depth 2 in f32 (TF32 off), one
   seeded weight set in an engine on the card (kernel) and one on the
   CPU (plain version), 4 greedy requests x 16 tokens, token-exact
   unless the CPU's top-2 logit margin at the divergence is < 1e-3 (a
   tie);
7. engine serve — full-width, full-depth Llama-1B in bf16, 24 requests
   of 384 prompt tokens (256 shared) x 32 new tokens on 8 slots:
   tokens/s, TTFT p50, peak device memory (the serving path's launches);
8. train parity — full-width Llama-1B at depth 2 in f32 (TF32 off), one
   seeded weight set trained by the port's Trainer on the card (kernels)
   and on the CPU (plain versions), 3 adamw steps (losses within rtol
   1e-4, parameters within 2·lr·steps), then 3 sgd steps (losses within
   rtol 1e-5, each parameter's last-step gradient within 1e-3 of its
   max-abs: the check that holds K2's gradients on the training path),
   then 3 sgd steps with ``remat="dots"`` and the backward's threshold at
   0 on both sides (the same check for K3a, K3b and remat);
9. train converge — a width-64 tiny Llama with flash attention learns
   the synthetic next-token task on the card (last loss < 0.7 x first);
10. train step — full-width, full-depth Llama-1B, bf16 compute over f32
    parameters, adamw, B 4 x S 2048: 2 warm-up then 5 timed steps through
    ``Trainer.fit`` and one ``evaluate`` batch: tokens/s, ms/step, 6ND
    MFU, peak device memory, the losses, and the launches of each flash
    kernel (the training path's launches);
11. train long — the same model with ``remat="dots"`` at B 1 x S 8192:
    2 warm-up then 5 timed steps through ``Trainer.fit``, the same
    figures, and per step 16 K3a, 16 K3b, no K2 and 32 K1 with the LSE
    (16 in the forward, 16 in the remat recompute) — the long-context
    path's launches;
12. fused loss — full-width Llama-1B at depth 2, B 1 x S 8192, one
    forward+backward through ``fused_lm_loss`` against one through the
    materialized logits and the trainer's cross-entropy: the losses'
    relative difference (within 2e-3), each parameter gradient's error
    relative to its max-abs (within 2e-2: bf16 logits there, f32 here),
    the ms and the peak device memory of each;
13. resnet parity — full-width, full-depth ResNet-50 in f32 (TF32 off,
    ``torch.backends.cudnn.benchmark`` False), one seeded weight set
    trained by the port's Trainer on the card (cuDNN) and on the CPU with
    SGD at lr 0.005 and the gradient norm logged, B 4 x 224, for each
    stem: 3 free-running steps (printed; the first gated: a BatchNorm net
    at init parts the two sides' runs after it), then 3 steps each from
    the CPU's state copied to the card: losses within rtol 1e-4, gradient
    norms within 1e-3 relative, parameters within 2·lr·steps, each
    BatchNorm buffer within 1e-4 of its max-abs;
14. resnet converge — ``tiny_resnet`` through ``Trainer.fit`` on synthetic
    32x32 images with ``standard_augment(crop=32)``,
    ``standard_eval_transform(crop=32)``, validation data,
    ``ReduceLROnPlateau`` and ``EarlyStopping`` (last loss < 0.7 x
    first);
15. resnet train — ``bench.py``'s step through ``Trainer.train_step`` on a
    batch resident on the card: ResNet-50, bf16 compute over f32
    parameters, BatchNorm in train mode, adam at 1e-3, B 256 x 224, with
    ``torch.backends.cudnn.benchmark`` True: 2 warm-up then 10 timed
    steps with the Keras stem, then 3 warm-up and 20 timed steps with the
    space-to-depth stem (bench.py's default): images/s, ms/step, peak
    device memory, the last loss, the forward's multiply-accumulates per
    image (from the model's conv and dense shapes) and the MFU of
    6 x MACs per image;
16. kernels — one JSON object: every ported kernel with its launches on
    its main path (phase 7, 10 or 11), error, times and bound (K3b's
    library time is SDPA's backward, which computes dq, dk and dv, as
    ``library_computes`` says; K4's other timing shapes under
    ``shapes``); the ResNet path adds none (the JAX package runs no
    Pallas kernel there);

and, as its last line, ``{"ok": true, "device": {...}}``. Any failure
raises: the script exits non-zero and prints no result. It needs the
repository beside it and a card (``torch.cuda.is_available()``).
``--profile DIR`` adds a profiled decode window after phase 7, one
profiled train step after each of phases 10, 11 and 15 (the last with
its device time by kernel class: convolutions, BatchNorm, elementwise
ops and casts, adam, ...), and writes their kernel tables to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from pddl_tpu_torch.data.synthetic import (
    SyntheticImageClassification,
    SyntheticLanguageModeling,
)
from pddl_tpu_torch.models.gpt import fused_lm_loss
from pddl_tpu_torch.models.llama import Llama_1B, tiny_llama
from pddl_tpu_torch.models.resnet import Conv, ResNet50, tiny_resnet
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.ops.augment import standard_augment, standard_eval_transform
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import FinishReason
from pddl_tpu_torch.train.callbacks import EarlyStopping, ReduceLROnPlateau
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.metrics import sparse_categorical_crossentropy

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}  # of max |grad|
VOCAB, MAX_LEN = 128256, 1024          # as benchmarks/decode_bench.py builds it
DEV = torch.device("cuda", 0)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# ------------------------------------------------------------ phase 1-2
def device_line() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    t0 = time.perf_counter()
    _kernels.build(extra_flags=("-Xptxas", "-v"))
    for name in _kernels.SOURCES:
        _kernels.library(name)
    return time.perf_counter() - t0


# -------------------------------------------------------------- phase 3
def paged_case(gen, *, b, h, hkv, d, bs, t, depths, dtype):
    """Random pools, a random permutation of block ids as the tables
    (the kernel must follow the indirection), q, per-row depths."""
    n = 1 + b * t
    kp = torch.randn(n, hkv, bs, d, generator=gen, device=DEV).to(dtype)
    vp = torch.randn(n, hkv, bs, d, generator=gen, device=DEV).to(dtype)
    table = (torch.randperm(n - 1, generator=gen, device=DEV)[:b * t] + 1)
    q = torch.randn(b, h, 1, d, generator=gen, device=DEV).to(dtype)
    index = torch.tensor(depths, dtype=torch.int32, device=DEV)
    return q, kp, vp, table.view(b, t).to(torch.int32), index


def compare(case, window):
    got = tatt.paged_decode_attention_kernel(*case, window=window)
    ref = tatt.paged_decode_attention(*case, window=window, kernel=False)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise RuntimeError("paged_decode kernel produced non-finite output")
    return float((got.float() - ref.float()).abs().max())


def cuda_ms(fn, n_copies: int, iters: int = 200) -> float:
    """Mean ms per call on CUDA events, cycling over ``n_copies`` input
    sets so the working set exceeds the 50 MB L2 (as in the tick, where
    16 layers' pools and the weights stream between two launches)."""
    for i in range(2 * n_copies):
        fn(i % n_copies)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n_copies: int, calls: int = 32, reps: int = 200) -> float:
    """Device ms per call: ``calls`` calls (cycling over ``n_copies`` input
    sets) captured in one CUDA graph, replayed ``reps`` times after 50
    warm-up replays, on CUDA events. Where a call's device work is
    shorter than its wrapper's host time, eager launches leave the card
    idle between calls and :func:`cuda_ms` measures the host; the graph
    replays the same launches back to back."""
    for i in range(n_copies):
        fn(i)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_copies)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n_copies)
    for _ in range(50):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def decode_bound_ms(case):
    """Least time for one call and what sets it: the bytes it must move
    (q, the live K/V prefix of every row, the table entries it follows,
    the index and the output) over HBM bandwidth, or its flops over the
    dtype's peak — whichever is larger. Returns ``(ms, "bytes" |
    "operations")``."""
    q, kp, _, table, index = case
    b, h, _, d = q.shape
    _, hkv, bs, _ = kp.shape
    live = index.long().cpu() + 1                     # tokens per row
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz                      # q in, out
              + int(live.sum()) * 2 * hkv * d * isz    # K and V
              + int(((live + bs - 1) // bs).sum()) * 4 + b * 4)
    flops = 4 * h * d * int(live.sum())
    return _bound(nbytes, flops, q.dtype)


def _bound(nbytes, flops, dtype):
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def sdpa_fn(cases):
    """The library yardstick: SDPA over each case's K/V gathered dense
    (gather done here, untimed), masked to each row's depth. Used only
    to time; the port never calls it."""
    dense = []
    for q, kp, vp, table, index in cases:
        b, h, _, d = q.shape
        _, hkv, bs, _ = kp.shape
        t = table.shape[1]
        ids = table.long()
        k = kp[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, t * bs, d)
        v = vp[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, t * bs, d)
        k = k.repeat_interleave(h // hkv, dim=1).contiguous()
        v = v.repeat_interleave(h // hkv, dim=1).contiguous()
        pos = torch.arange(t * bs, device=DEV)
        mask = (pos[None, :] <= index[:, None].long())[:, None, None, :]
        dense.append((q, k, v, mask))

    def fn(i):
        q, k, v, mask = dense[i]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return fn


# K4's timing shapes (bf16): Llama-1B's decode shape at the agreement
# case's mixed depths; the engine's steady tick (8 rows at depth 390); one
# row at Llama_1B's max_len 4096 (T 256), where one block per (row, kv
# head) would leave most of the card idle.
LLAMA_DECODE = dict(b=8, h=32, hkv=8, d=64, bs=16, t=64)
PAGED_TIMING = {
    "mixed": dict(LLAMA_DECODE, depths=[0, 7, 16, 100, 391, 512, 777,
                                        64 * 16 - 1]),
    "tick": dict(LLAMA_DECODE, depths=[390] * 8),
    "long_row": dict(LLAMA_DECODE, b=1, t=256, depths=[4095]),
}


def paged_split_edges(gen):
    """Agreement cases at the edges of K4's split of the table (the plan
    the wrapper takes on this card): depths at a split boundary and one
    past it, a window from one split into the next, a table far wider
    than the deepest row, rep 1 and rep 8, D 256 with bs 64, and table
    entries outside [0, N), which read block 0 (held against the plain
    version on the table with those entries at 0). ``name -> (err, tol)``."""
    sms = tatt._sm_count(DEV.index or 0)
    n_split, per = tatt.paged_split_plan(8, 8, 64, 16, sms)
    edge = per * 16                       # first position of split 1
    depths = [edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge, 0, 390,
              64 * 16 - 1]
    cases = {
        "split_edges": (dict(LLAMA_DECODE, depths=depths), (None, 100)),
        "wide_table": (dict(LLAMA_DECODE, b=4, t=256, depths=[0, 15, 16, 40]),
                       (None, 6)),
        "rep1": (dict(LLAMA_DECODE, b=4, hkv=32, depths=[0, 127, 128, 1000]),
                 (None, 100)),
        "rep8": (dict(LLAMA_DECODE, b=4, hkv=4, depths=[1, 127, 128, 1023]),
                 (None, 100)),
        "d256_bs64": (dict(b=2, h=8, hkv=2, d=256, bs=64, t=16,
                           depths=[63, 1023]), (None, 100)),
    }
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, (shape, windows) in cases.items():
            case = paged_case(gen, dtype=dtype, **shape)
            for window in windows:
                errs[f"{name}_{dn}_w{window}"] = (compare(case, window),
                                                  TOL[dtype])
        q, kp, vp, table, index = paged_case(gen, dtype=dtype,
                                             **PAGED_TIMING["mixed"])
        bad = table.clone()
        bad[0, 0], bad[3, 5], bad[7, 60] = -7, kp.shape[0], kp.shape[0] + 11
        got = tatt.paged_decode_attention_kernel(q, kp, vp, bad, index)
        sink = torch.where((bad >= 0) & (bad < kp.shape[0]), bad, 0)
        ref = tatt.paged_decode_attention(q, kp, vp, sink, index,
                                          kernel=False)
        torch.cuda.synchronize()
        errs[f"table_out_of_range_{dn}"] = (
            float((got.float() - ref.float()).abs().max()), TOL[dtype])
    return n_split, per, errs


def time_paged(gen, shape):
    """K4's time at one shape on 8 copies of the inputs (~134 MB at the
    Llama shape, so every launch reads K/V from HBM as in the tick, where
    16 layers' pools and the weights stream between launches): ``ms`` and
    the SDPA yardstick's ``library_ms`` are device times from a CUDA graph
    (:func:`graph_ms`); ``eager_ms`` times the same wrapper calls launched
    one by one (:func:`cuda_ms`), which is the wrapper's host time where
    that is the longer; the plain version (``plain_ms``, eager: it reads
    the depths on the host) and the bound beside them."""
    cases = [paged_case(gen, dtype=torch.bfloat16, **shape)
             for _ in range(8)]

    def kernel(i):
        return tatt.paged_decode_attention_kernel(*cases[i])

    ms = graph_ms(kernel, 8)
    eager_ms = cuda_ms(kernel, 8)
    plain_ms = cuda_ms(lambda i: tatt.paged_decode_attention(
        *cases[i], kernel=False), 8, iters=50)
    library_ms = graph_ms(sdpa_fn(cases), 8)
    bound_ms, bound_by = decode_bound_ms(cases[0])
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_paged_decode():
    gen = torch.Generator(device=DEV).manual_seed(0)
    llama = PAGED_TIMING["mixed"]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        case = paged_case(gen, dtype=dtype, **llama)
        for window in (None, 128):
            errs[f"llama1b_{dn}_w{window}"] = (compare(case, window),
                                               TOL[dtype])
        odd = paged_case(gen, b=4, h=12, hkv=4, d=128, bs=16, t=8,
                         depths=[0, 5, 70, 127], dtype=dtype)
        errs[f"rep3_d128_{dn}"] = (compare(odd, None), TOL[dtype])
    tiny = paged_case(gen, b=3, h=4, hkv=2, d=8, bs=4, t=6,
                      depths=[23, 0, 9], dtype=torch.float32)
    for window in (None, 6):
        errs[f"tiny_f32_w{window}"] = (compare(tiny, window),
                                       TOL[torch.float32])
    n_split, per, edge_errs = paged_split_edges(gen)
    errs.update(edge_errs)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("paged_decode", cases=len(errs),
          split_plan=f"{n_split}x{per}_entries",
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, (e, tol)
                          in errs.items()))
    if bad:
        raise RuntimeError(f"paged_decode kernel disagrees with plain: {bad}")

    # Two runs bitwise equal at the Llama-1B shape: the splits merge in a
    # fixed order.
    case = paged_case(gen, dtype=torch.bfloat16, **llama)
    first = tatt.paged_decode_attention_kernel(*case)
    second = tatt.paged_decode_attention_kernel(*case)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise RuntimeError("paged_decode: two runs differ at the Llama-1B "
                           "shape")
    phase("paged_decode_bitwise", shape="B8_H32_Hkv8_D64_bs16_T64_bf16",
          equal=True)

    timings = {}
    for name, shape in PAGED_TIMING.items():
        timings[name] = t = time_paged(gen, shape)
        phase("paged_decode_time", case=name,
              shape=f"B{shape['b']}_H{shape['h']}_Hkv{shape['hkv']}_"
                    f"D{shape['d']}_bs{shape['bs']}_T{shape['t']}_bf16",
              depths="/".join(map(str, shape["depths"])),
              split_plan="x".join(map(str, tatt.paged_split_plan(
                  shape["b"], shape["hkv"], shape["t"], shape["bs"],
                  tatt._sm_count(DEV.index or 0)))),
              **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                 for k, v in t.items()})
    err = max(e for k, (e, _) in errs.items() if k.startswith("llama1b_bf16"))
    return {**timings["mixed"], "max_abs_err": err,
            "shapes": {k: v for k, v in timings.items() if k != "mixed"}}


# ---------------------------------------------------------- phase 4-5
# (b, h, hkv, sq, sk, d, dtype, causal, window, k_offset)
FLASH_CASES = {
    "llama1b": (4, 32, 8, 2048, 2048, 64, torch.bfloat16, True, None, 0),
    "llama1b_w512": (4, 32, 8, 2048, 2048, 64, torch.bfloat16, True, 512, 0),
    "mha": (2, 16, 16, 2048, 2048, 64, torch.bfloat16, True, None, 0),
    "rep3_d128": (2, 12, 4, 1024, 1024, 128, torch.bfloat16, True, None, 0),
    "ragged1000": (2, 8, 2, 1000, 1000, 64, torch.bfloat16, True, None, 0),
    "k_offset": (2, 8, 2, 512, 512, 64, torch.bfloat16, True, 384, -256),
    "f32": (2, 8, 2, 1024, 1024, 64, torch.float32, True, None, 0),
    "s129": (2, 8, 2, 129, 129, 64, torch.bfloat16, True, None, 0),
    "full_bf16": (2, 4, 2, 200, 136, 64, torch.bfloat16, False, None, 0),
    "window6": (2, 8, 2, 300, 300, 64, torch.bfloat16, True, 6, 0),
    "sk257": (2, 8, 2, 257, 257, 64, torch.bfloat16, True, None, 0),
    "sk257_window12": (2, 8, 2, 257, 257, 64, torch.bfloat16, True, 12, 0),
}
WITH_DLSE = ("llama1b", "k_offset")


def flash_case(gen, b, h, hkv, sq, sk, d, dtype, causal, window, k_offset):
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    dlse = torch.randn(b, h, sq, generator=gen, device=DEV)
    kw = dict(causal=causal, scale=d ** -0.5, window=window,
              k_offset=k_offset)
    return (q, k, v), do, dlse, kw


def flash_fwd_bound_ms(q, k, want_lse=True):
    """Least time of one causal forward and what sets it: 2·B·H·S²·D
    flops over the bf16 tensor-core peak, or the bytes of q, k, v read
    once and o (and lse) written once over HBM bandwidth."""
    b, h, s, d = q.shape
    nbytes = ((2 * q.numel() + 2 * k.numel()) * q.element_size()
              + (b * h * s * 4 if want_lse else 0))
    flops = 2 * b * h * s * s * d
    return _bound(nbytes, flops, q.dtype)


def flash_bwd_bound_ms(q, k):
    """As :func:`flash_fwd_bound_ms` for the backward: 5·B·H·S²·D causal
    flops; q, o, do read and dq written, k, v read and dk, dv written,
    lse read."""
    b, h, s, d = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + b * h * s * 4
    flops = 5 * b * h * s * s * d
    return _bound(nbytes, flops, q.dtype)


def phase_flash_fwd():
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {}
    for name, shape in FLASH_CASES.items():
        qkv, _, _, kw = flash_case(gen, *shape)
        ref_o, ref_lse = tatt.flash_forward_plain(*qkv, **kw)
        for want_lse in (True, False):
            o, lse = tatt.flash_forward(*qkv, want_lse=want_lse, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(o.float()).all():
                raise RuntimeError(f"flash_fwd {name}: non-finite output")
            err = float((o.float() - ref_o.float()).abs().max())
            if want_lse:
                err = max(err, float((lse - ref_lse).abs().max()))
            errs[f"{name}_{'lse' if want_lse else 'nolse'}"] = (
                err, TOL[qkv[0].dtype])
        del qkv, ref_o, ref_lse
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("flash_fwd", cases=len(errs),
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, (e, tol)
                          in errs.items()))
    if bad:
        raise RuntimeError(f"flash_fwd kernel disagrees with plain: {bad}")

    # Times at Llama-1B's training shape: two input sets (~100 MB). First,
    # two runs on one set must agree bit for bit (no atomics; the remat
    # recompute relies on it).
    cases = [flash_case(gen, *FLASH_CASES["llama1b"]) for _ in range(2)]
    kw = cases[0][3]
    first, second = (tatt.flash_forward(*cases[0][0], **kw) for _ in range(2))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    phase("flash_fwd_bitwise", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          o_and_lse_equal=bitwise)
    if not bitwise:
        raise RuntimeError("two K1 runs gave different o or lse")
    del first, second
    ms = cuda_ms(lambda i: tatt.flash_forward(*cases[i][0], **kw), 2,
                 iters=20)
    ms_nolse = cuda_ms(lambda i: tatt.flash_forward(
        *cases[i][0], want_lse=False, **kw), 2, iters=20)
    plain_ms = cuda_ms(lambda i: tatt.flash_forward_plain(*cases[i][0], **kw),
                       2, iters=4)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        *cases[i][0], is_causal=True, enable_gqa=True), 2, iters=20)
    bound_ms, bound_by = flash_fwd_bound_ms(*cases[0][0][:2])
    nolse_bound_ms, nolse_bound_by = flash_fwd_bound_ms(*cases[0][0][:2],
                                                        want_lse=False)
    phase("flash_fwd_time", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          ms=f"{ms:.5f}", ms_nolse=f"{ms_nolse:.5f}",
          plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
          bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    common = {"plain_ms": plain_ms, "library_ms": library_ms}
    return {
        "flash_fwd": {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": errs["llama1b_lse"][0], **common},
        "flash_fwd_nolse": {"ms": ms_nolse, "bound_ms": nolse_bound_ms,
                            "bound_by": nolse_bound_by,
                            "max_abs_err": errs["llama1b_nolse"][0],
                            **common}}


def phase_flash_bwd():
    gen = torch.Generator(device=DEV).manual_seed(2)
    errs, abs_errs = {}, {}
    for name, shape in FLASH_CASES.items():
        qkv, do, dlse, kw = flash_case(gen, *shape)
        o, lse = tatt.flash_forward_plain(*qkv, **kw)
        for cot in ((None, dlse) if name in WITH_DLSE else (None,)):
            got = tatt.flash_backward(*qkv, o, lse, do, cot, **kw)
            want = tatt.flash_backward_plain(*qkv, o, lse, do, cot, **kw)
            torch.cuda.synchronize()
            tag = name + ("_dlse" if cot is not None else "")
            rel = []
            for g, w, x in zip(got, want, qkv):
                if g.shape != x.shape or g.dtype != x.dtype or not \
                        torch.isfinite(g.float()).all():
                    raise RuntimeError(f"flash_bwd {tag}: bad gradient")
                err = float((g.float() - w.float()).abs().max())
                rel.append(err / float(w.float().abs().max()))
                abs_errs[tag] = max(abs_errs.get(tag, 0.0), err)
            errs[tag] = (max(rel), GRAD_TOL[qkv[0].dtype])
            del got, want
        del qkv, do, o, lse
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("flash_bwd", cases=len(errs), relative_errors=" ".join(
        f"{k}:{e:.3g}/{tol:g}" for k, (e, tol) in errs.items()))
    if bad:
        raise RuntimeError(f"flash_bwd kernel disagrees with plain: {bad}")

    cases = []
    for _ in range(2):
        qkv, do, _, kw = flash_case(gen, *FLASH_CASES["llama1b"])
        o, lse = tatt.flash_forward(*qkv, **kw)
        cases.append((qkv, o, lse, do))
    # dk and dv are summed inside one block and written once: two K2 runs
    # on one set agree bit for bit (dq, added with atomics, need not).
    first, second = (tatt.flash_backward(*cases[0][0], *cases[0][1:], **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first[1:], second[1:]))
    phase("flash_bwd_bitwise", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          dk_and_dv_equal=bitwise)
    if not bitwise:
        raise RuntimeError("two K2 runs gave different dk or dv")
    del first, second
    ms = cuda_ms(lambda i: tatt.flash_backward(
        *cases[i][0], *cases[i][1:], **kw), 2, iters=10)
    plain_ms = cuda_ms(lambda i: tatt.flash_backward_plain(
        *cases[i][0], *cases[i][1:], **kw), 2, iters=2)
    leaves = [[x.detach().requires_grad_() for x in c[0]] for c in cases]

    def sdpa(i, backward):
        o = F.scaled_dot_product_attention(*leaves[i], is_causal=True,
                                           enable_gqa=True)
        if backward:
            o.backward(cases[i][3])
    sdpa_fb = cuda_ms(lambda i: sdpa(i, True), 2, iters=10)
    sdpa_f = cuda_ms(lambda i: sdpa(i, False), 2, iters=10)
    library_ms = sdpa_fb - sdpa_f
    bound_ms, bound_by = flash_bwd_bound_ms(*cases[0][0][:2])
    phase("flash_bwd_time", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=f"{library_ms:.5f}",
          sdpa_fwd_bwd_ms=f"{sdpa_fb:.5f}", bound_ms=f"{bound_ms:.5f}",
          bound_by=bound_by)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "max_abs_err": max(v for k, v in abs_errs.items()
                               if k.startswith("llama1b"))}


# ------------------------------------------------------------- phase 5b
# Llama-1B at long context: rep 4 · S 8192 · D 64 · 4 bytes = 8 MiB of
# fused dq accumulator, above the JAX package's 6 MiB, so its backward
# takes the two sweeps K3a/K3b with nothing patched.
LONG = (1, 32, 8, 8192, 8192, 64, torch.bfloat16, True, None, 0)
TWO_SWEEP_ODD = ("llama1b_w512", "mha", "rep3_d128", "ragged1000",
                 "k_offset", "f32", "s129", "full_bf16", "window6", "sk257",
                 "sk257_window12")


@contextlib.contextmanager
def dispatch_threshold(nbytes):
    """Set the backward's K2/K3 dispatch threshold for the block: 0 sends
    every shape to K3a/K3b, a huge one every shape to K2."""
    old = tatt._FUSED_BWD_DQ_BYTES
    tatt._FUSED_BWD_DQ_BYTES = nbytes
    try:
        yield
    finally:
        tatt._FUSED_BWD_DQ_BYTES = old


def two_sweep_bound_ms(q, k, sweep):
    """Least time of K3a (``dq``: 3 products per causal tile pair; q, do,
    k, v, lse and di read, dq written) or K3b (``dkv``: 4 products; the
    same read, dk and dv written), each product 2·B·H·S²·D/2 causal
    flops."""
    b, h, s, d = q.shape
    products, q_like, k_like = {"dq": (3, 3, 2), "dkv": (4, 2, 4)}[sweep]
    nbytes = ((q_like * q.numel() + k_like * k.numel()) * q.element_size()
              + 2 * b * h * s * 4)
    return _bound(nbytes, products * b * h * s * s * d, q.dtype)


def rel_errs(got, want):
    """Each gradient's max-abs error relative to the reference's max-abs."""
    return [float((g.float() - w.float()).abs().max())
            / float(w.float().abs().max()) for g, w in zip(got, want)]


def check_flash_fwd_long(qkv, kw, ref_o, ref_lse):
    """K1 at the long shape against the plain forward's o and lse, with
    and without its LSE, and two runs on the same inputs bitwise equal."""
    errs, bitwise = {}, {}
    for want_lse in (True, False):
        tag = "lse" if want_lse else "nolse"
        runs = [tatt.flash_forward(*qkv, want_lse=want_lse, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        o, lse = runs[0]
        if not torch.isfinite(o.float()).all():
            raise RuntimeError(f"flash_fwd llama1b_s8192_{tag}: non-finite")
        err = float((o.float() - ref_o.float()).abs().max())
        if want_lse:
            err = max(err, float((lse - ref_lse).abs().max()))
        errs[tag] = err
        bitwise[tag] = all(a is None and b is None or torch.equal(a, b)
                           for a, b in zip(*runs))
        del runs, o, lse
    tol = TOL[torch.bfloat16]
    phase("flash_fwd_long", shape="B1_H32_Hkv8_S8192_D64_bf16_causal",
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, e in errs.items()),
          bitwise_equal=" ".join(f"{k}:{v}" for k, v in bitwise.items()))
    if not max(errs.values()) <= tol:
        raise RuntimeError(f"flash_fwd disagrees with plain at S 8192: {errs}")
    if not all(bitwise.values()):
        raise RuntimeError(f"two K1 runs at S 8192 differ: {bitwise}")


def phase_flash_bwd_two_sweep():
    gen = torch.Generator(device=DEV).manual_seed(4)
    errs, long_abs = {}, {}
    cases = [("llama1b_s8192", LONG)] + [(n, FLASH_CASES[n])
                                         for n in TWO_SWEEP_ODD]
    for name, shape in cases:
        qkv, do, dlse, kw = flash_case(gen, *shape)
        with (contextlib.nullcontext() if name == "llama1b_s8192"
              else dispatch_threshold(0)):
            if not tatt.takes_two_sweeps(*qkv[:2]):
                raise RuntimeError(f"{name} does not take the two sweeps")
            o, lse = tatt.flash_forward_plain(*qkv, **kw)
            if name == "llama1b_s8192":
                check_flash_fwd_long(qkv, kw, o, lse)
            for cot in ((None, dlse) if name in WITH_DLSE else (None,)):
                before = dict(_kernels.launch_counts)
                got = tatt.flash_backward(*qkv, o, lse, do, cot, **kw)
                torch.cuda.synchronize()
                moved = {k: _kernels.launch_counts[k] - before[k]
                         for k in before if _kernels.launch_counts[k]
                         != before[k]}
                if moved != {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
                    raise RuntimeError(f"two-sweep {name} launched {moved}")
                want = tatt.flash_backward_plain(*qkv, o, lse, do, cot, **kw)
                torch.cuda.synchronize()
                tag = name + ("_dlse" if cot is not None else "")
                for g, x in zip(got, qkv):
                    if g.shape != x.shape or g.dtype != x.dtype or not \
                            torch.isfinite(g.float()).all():
                        raise RuntimeError(f"two-sweep {tag}: bad gradient")
                if name == "llama1b_s8192":
                    long_abs = {"dq": float((got[0].float() - want[0].float())
                                            .abs().max()),
                                "dkv": max(float((g.float() - w.float())
                                                 .abs().max()) for g, w
                                           in zip(got[1:], want[1:]))}
                errs[tag] = (max(rel_errs(got, want)),
                             GRAD_TOL[qkv[0].dtype])
                del got, want
        del qkv, do, o, lse
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("flash_bwd_two_sweep", cases=len(errs), relative_errors=" ".join(
        f"{k}:{e:.3g}/{tol:g}" for k, (e, tol) in errs.items()))
    if bad:
        raise RuntimeError(f"K3a/K3b disagree with plain: {bad}")

    # At the long shape: K3 against K2 (the same function), K3a twice
    # (bitwise), then times on two input sets.
    sets = []
    for _ in range(2):
        qkv, do, _, kw = flash_case(gen, *LONG)
        o, lse = tatt.flash_forward(*qkv, **kw)
        sets.append((qkv, o, lse, do, tatt._row_term(o, do)))
    qkv, o, lse, do, di = sets[0]
    k3 = tatt.flash_backward(*qkv, o, lse, do, **kw)
    with dispatch_threshold(1 << 62):
        k2 = tatt.flash_backward(*qkv, o, lse, do, **kw)
        k2_again = tatt.flash_backward(*qkv, o, lse, do, **kw)
    vs_k2 = rel_errs(k3, k2)
    dq_again = tatt.flash_backward_dq(*qkv, do, lse, di, **kw)
    dkv_again = tatt.flash_backward_dkv(*qkv, do, lse, di, **kw)
    torch.cuda.synchronize()
    bitwise = {"k3a_dq": bool(torch.equal(dq_again, k3[0])),
               "k3b_dk_dv": all(torch.equal(a, b)
                                for a, b in zip(dkv_again, k3[1:])),
               "k2_dk_dv": all(torch.equal(a, b)
                               for a, b in zip(k2_again[1:], k2[1:]))}
    phase("flash_bwd_two_sweep_vs_k2", shape="B1_H32_Hkv8_S8192_D64_bf16",
          dq=f"{vs_k2[0]:.3g}", dk=f"{vs_k2[1]:.3g}", dv=f"{vs_k2[2]:.3g}",
          tol=f"{GRAD_TOL[torch.bfloat16]:g}", bitwise_equal=" ".join(
              f"{k}:{v}" for k, v in bitwise.items()))
    if not max(vs_k2) <= GRAD_TOL[torch.bfloat16]:
        raise RuntimeError(f"K3 and K2 disagree: {vs_k2}")
    if not all(bitwise.values()):
        raise RuntimeError(f"two runs differ at S 8192: {bitwise}")
    del k3, k2, k2_again, dq_again, dkv_again

    dq_ms = cuda_ms(lambda i: tatt.flash_backward_dq(
        *sets[i][0], sets[i][3], sets[i][2], sets[i][4], **kw), 2, iters=10)
    dkv_ms = cuda_ms(lambda i: tatt.flash_backward_dkv(
        *sets[i][0], sets[i][3], sets[i][2], sets[i][4], **kw), 2, iters=10)
    pair_ms = cuda_ms(lambda i: tatt.flash_backward(
        *sets[i][0], *sets[i][1:4], **kw), 2, iters=10)
    with dispatch_threshold(1 << 62):
        k2_ms = cuda_ms(lambda i: tatt.flash_backward(
            *sets[i][0], *sets[i][1:4], **kw), 2, iters=10)
    plain_ms = cuda_ms(lambda i: tatt.flash_backward_plain(
        *sets[i][0], *sets[i][1:4], **kw), 2, iters=2)
    leaves = [[x.detach().requires_grad_() for x in c[0]] for c in sets]

    def sdpa(i, backward):
        o = F.scaled_dot_product_attention(*leaves[i], is_causal=True,
                                           enable_gqa=True)
        if backward:
            o.backward(sets[i][3])
    sdpa_fb = cuda_ms(lambda i: sdpa(i, True), 2, iters=10)
    sdpa_f = cuda_ms(lambda i: sdpa(i, False), 2, iters=10)
    sdpa_bwd = sdpa_fb - sdpa_f
    k1_ms = cuda_ms(lambda i: tatt.flash_forward(*sets[i][0], **kw), 2,
                    iters=10)
    k1_nolse_ms = cuda_ms(lambda i: tatt.flash_forward(
        *sets[i][0], want_lse=False, **kw), 2, iters=10)
    q, k = sets[0][0][:2]
    k1_bound, _ = flash_fwd_bound_ms(q, k)
    dq_bound, dq_by = two_sweep_bound_ms(q, k, "dq")
    dkv_bound, dkv_by = two_sweep_bound_ms(q, k, "dkv")
    phase("flash_bwd_two_sweep_time", shape="B1_H32_Hkv8_S8192_D64_bf16",
          dq_ms=f"{dq_ms:.5f}", dkv_ms=f"{dkv_ms:.5f}",
          sum_ms=f"{dq_ms + dkv_ms:.5f}", wrapper_ms=f"{pair_ms:.5f}",
          k2_ms=f"{k2_ms:.5f}", sdpa_bwd_ms=f"{sdpa_bwd:.5f}",
          sdpa_fwd_ms=f"{sdpa_f:.5f}", k1_ms=f"{k1_ms:.5f}",
          k1_nolse_ms=f"{k1_nolse_ms:.5f}",
          k1_bound_ms=f"{k1_bound:.5f}",
          plain_ms=f"{plain_ms:.5f}", dq_bound_ms=f"{dq_bound:.5f}",
          dkv_bound_ms=f"{dkv_bound:.5f}", bound_by=f"{dq_by}/{dkv_by}")
    # No PyTorch call computes dq alone or dk, dv alone: SDPA's backward,
    # which computes all three, is K3b's yardstick and that of the pair.
    return {"flash_bwd_dq": {"ms": dq_ms, "bound_ms": dq_bound,
                             "bound_by": dq_by, "plain_ms": plain_ms,
                             "max_abs_err": long_abs["dq"],
                             "library_ms": None},
            "flash_bwd_dkv": {"ms": dkv_ms, "bound_ms": dkv_bound,
                              "bound_by": dkv_by, "plain_ms": plain_ms,
                              "max_abs_err": long_abs["dkv"],
                              "library_ms": sdpa_bwd,
                              "library_computes": "dq, dk and dv (the "
                              "yardstick of flash_bwd_dq and flash_bwd_dkv "
                              "together)"}}


# -------------------------------------------------------------- phase 6
def top2_margin(model, tokens) -> float:
    with torch.no_grad():
        logits = model(torch.tensor([tokens], device=model.device))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def phase_engine_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=VOCAB, max_len=MAX_LEN, depth=2,
               dtype=torch.float32)
    cpu_model = Llama_1B(**cfg, device="cpu", seed=1)
    gpu_model = Llama_1B(**cfg, device=DEV, seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(4)
    shared = rng.randint(0, VOCAB, 32)
    prompts = [np.concatenate([shared, rng.randint(0, VOCAB, 16)]),
               rng.randint(0, VOCAB, 80),
               np.concatenate([shared, rng.randint(0, VOCAB, 32)]),
               rng.randint(0, VOCAB, 100)]
    streams = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = ServeEngine(model, device=model.device, max_slots=4,
                          prefill_len=128, prefix_block_size=16)
        handles = [eng.submit(p, 16) for p in prompts]
        eng.run(max_steps=200)
        streams[name] = [h.tokens for h in handles]
    exact, ties = 0, []
    for i, prompt in enumerate(prompts):
        a, b = streams["cuda"][i], streams["cpu"][i]
        if len(a) != 16 or len(b) != 16:
            raise RuntimeError(f"request {i} emitted {len(a)}/{len(b)} tokens")
        diverge = next((j for j in range(16) if a[j] != b[j]), None)
        if diverge is None:
            exact += 1
            continue
        margin = top2_margin(cpu_model,
                             list(prompt) + list(b[:diverge]))
        if margin >= 1e-3:
            raise RuntimeError(
                f"request {i} diverges at token {diverge} "
                f"(cuda {a[diverge]}, cpu {b[diverge]}) with a CPU top-2 "
                f"margin of {margin:.3g} >= 1e-3")
        ties.append((i, diverge, margin))
    phase("engine_parity", model="Llama_1B_depth2_f32", allow_tf32=False,
          requests=len(prompts), token_exact=exact,
          ties=";".join(f"req{i}@{j}:margin={m:.3g}" for i, j, m in ties)
          or "none")
    del cpu_model, gpu_model


# -------------------------------------------------------------- phase 7
def phase_engine_serve():
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, max_len=MAX_LEN,
                     dtype=torch.bfloat16, device=DEV, seed=0)
    rng = np.random.RandomState(5)
    shared = rng.randint(0, VOCAB, 256)
    prompts = [np.concatenate([shared, rng.randint(0, VOCAB, 128)])
               for _ in range(24)]
    eng = ServeEngine(model, paged=True, max_slots=8, prefix_block_size=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, 32) for p in prompts]
    max_shared = 0
    while eng.has_work:
        eng.step()
        max_shared = max(max_shared, eng.metrics.blocks_shared)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    ticks = sum(1 for r in eng.telemetry.snapshot() if r["live_slots"] > 0)
    if eng.telemetry.total_appended > eng.telemetry.capacity:
        raise RuntimeError("telemetry ring wrapped; ticks undercounted")
    for i, h in enumerate(handles):
        if h.finish_reason is not FinishReason.LENGTH or len(h.tokens) != 32:
            raise RuntimeError(f"request {i}: {h.finish_reason} with "
                               f"{len(h.tokens)} tokens")
        if not all(0 <= tok < VOCAB for tok in h.tokens):
            raise RuntimeError(f"request {i} emitted a token outside vocab")
    if max_shared <= 0:
        raise RuntimeError("no pool block was ever shared between slots")
    if launches["paged_decode"] < model.depth * ticks or ticks == 0:
        raise RuntimeError(f"paged_decode launched {launches} times over "
                           f"{ticks} ticks of a {model.depth}-layer model")
    snap = eng.metrics.snapshot()
    tokens = sum(len(h.tokens) for h in handles)
    # Steps that admitted nothing emit one token per live slot: the pure
    # decode ticks.
    tick_s = [r["tick_wall_s"] for r in eng.telemetry.snapshot()
              if r["live_slots"] and r["tokens"] == r["live_slots"]]
    phase("engine_serve", model="Llama_1B_bf16", requests=len(handles),
          tokens=tokens, wall_s=f"{wall:.4f}",
          tokens_per_s=f"{tokens / wall:.2f}",
          ttft_p50_s=f"{snap['ttft_p50_s']:.5f}",
          ttft_p99_s=f"{snap['ttft_p99_s']:.5f}", ticks=ticks,
          decode_tick_ms_p50=f"{1e3 * float(np.median(tick_s)):.4f}",
          paged_decode_launches=launches["paged_decode"],
          max_blocks_shared=max_shared,
          prefix_hits=snap["prefix_hits"],
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    return launches, model, prompts


def device_kernels(prof):
    """The profile's device kernels, largest device time first; user
    annotations (``record_function`` ranges such as the optimizer's step)
    carry device time too but span kernels already counted."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e for e in prof.key_averages() if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -e.self_device_time_total)


def profile_decode(model, prompts, out_dir: str, n_ticks: int = 8) -> None:
    """``--profile``: the wall time of one step that admits 8 requests,
    then a window of steady decode ticks (8 slots live at depth ~390)
    under ``torch.profiler``. Prints the tick's wall time, the
    device-busy share of the window, K4's device time and kernel launches
    per tick (its split and merge kernels) and the largest kernels by
    device time; writes the whole kernel table to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(model, max_slots=8, prefix_block_size=16)
    for p in prompts[:8]:
        eng.submit(p, 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # admits all 8 (one cold prompt, seven prefix hits), ticks
    torch.cuda.synchronize()
    admit_ms = 1e3 * (time.perf_counter() - t0)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / "profile_decode.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / n_ticks:.1f}us"
                   f"x{e.count // n_ticks}" for e in kern[:8])
    k4 = [e for e in kern if "paged_decode" in e.key]
    k4_ms = sum(e.self_device_time_total for e in k4) / 1e3 / n_ticks
    phase("profile_decode", admit_step_ms=f"{admit_ms:.4f}", ticks=n_ticks,
          tick_ms=f"{1e3 * wall / n_ticks:.4f}",
          device_busy_ms_per_tick=f"{busy_us / 1e3 / n_ticks:.4f}",
          paged_decode_ms_per_tick=f"{k4_ms:.4f}",
          paged_decode_kernels_per_tick=sum(e.count for e in k4) // n_ticks,
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          top_kernels_per_tick=top)


# ---------------------------------------------------------- phase 8-10
FLASH_COUNTERS = ("flash_fwd", "flash_fwd_nolse", "flash_bwd_fused",
                  "flash_bwd_dq", "flash_bwd_dkv")
LM_KEYS = dict(input_key="tokens", target_key="targets")


def _train_both(optimizer: str, lr: float, steps: int, **model_kw):
    """One seeded Llama-1B (depth 2, f32) trained ``steps`` steps by the
    port's Trainer on the card (kernels) and on the CPU (plain versions),
    on the same batches. Returns the per-step losses of each, their
    largest relative difference and, per parameter, the card's and the
    CPU's trained value and last step's gradient."""
    cfg = dict(vocab_size=VOCAB, depth=2, dtype=torch.float32, **model_kw)
    cpu_model = Llama_1B(**cfg, device="cpu", seed=2)
    gpu_model = Llama_1B(**cfg, device=DEV, seed=2)
    gpu_model.load_state_dict(cpu_model.state_dict())
    data = SyntheticLanguageModeling(batch_size=2, seq_len=256,
                                     vocab_size=VOCAB, seed=1)
    losses = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        tr = Trainer(model, optimizer=optimizer, learning_rate=lr,
                     device=model.device, **LM_KEYS)
        hist = tr.fit(data, epochs=steps, steps_per_epoch=1, verbose=0)
        losses[name] = hist.history["loss"]
    cpu_params = dict(cpu_model.named_parameters())
    params = {n: (p.detach().cpu(), cpu_params[n].detach(), p.grad.cpu(),
                  cpu_params[n].grad)
              for n, p in gpu_model.named_parameters()}
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["cuda"], losses["cpu"]))
    return losses, rel, params


def phase_train_parity(steps: int = 3, lr: float = 1e-4, sgd_lr: float = 1e-2):
    """AdamW (the optimizer path), then plain SGD, which keeps the two
    sides' parameters closest: the last step's gradient of every
    parameter on the card must equal the CPU's within GRAD_TOL of its
    max-abs, which a wrong dq, dk or dv from K2 breaks (AdamW's ±lr
    steps would hide it). Gradients are compared, not updates: an RMSNorm
    scale near 1 stores a 1e-5 update to within f32's 6e-8 rounding, so
    its update carries rounding of ~1e-3 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses, rel, params = _train_both("adamw", lr, steps)
    max_diff = max(float((g - c).abs().max())
                   for g, c, _, _ in params.values())
    phase("train_parity", model="Llama_1B_depth2_f32", allow_tf32=False,
          optimizer="adamw", lr=lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}",
          max_param_diff=f"{max_diff:.3g}",
          param_bound=f"{2 * lr * steps:g}")
    if not rel <= 1e-4:
        raise RuntimeError(f"train losses disagree: {losses}")
    if not max_diff <= 2 * lr * steps:
        raise RuntimeError(f"trained parameters differ by {max_diff}")
    del params
    _sgd_leg(steps, sgd_lr, "fused")
    # The long-context path at parity size: remat, and every backward
    # through K3a/K3b.
    with dispatch_threshold(0):
        _kernels.reset_launch_counts()
        _sgd_leg(steps, sgd_lr, "two_sweep_remat_dots", remat="dots")
    want = {"flash_fwd": 2 * 2 * steps, "flash_fwd_nolse": 0,
            "flash_bwd_fused": 0, "flash_bwd_dq": 2 * steps,
            "flash_bwd_dkv": 2 * steps}
    got = {k: _kernels.launch_counts[k] for k in want}
    if got != want:
        raise RuntimeError(f"remat parity leg launched {got}, want {want}")


def _sgd_leg(steps, lr, leg, **model_kw):
    """Train with sgd on the card and on the CPU; every parameter's
    last-step gradient must agree within GRAD_TOL of its max-abs."""
    losses, rel, params = _train_both("sgd", lr, steps, **model_kw)
    grad_rel = {}
    for name, (_, _, g, c) in params.items():
        scale = float(c.abs().max())
        if scale == 0.0:
            raise RuntimeError(f"{name} has a zero gradient on the CPU")
        grad_rel[name] = float((g - c).abs().max()) / scale
    worst = max(grad_rel, key=grad_rel.get)
    phase("train_parity", model="Llama_1B_depth2_f32", allow_tf32=False,
          optimizer="sgd", leg=leg, lr=lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}",
          max_grad_rel_diff=f"{grad_rel[worst]:.3g}", worst_leaf=worst,
          grad_bound=f"{GRAD_TOL[torch.float32]:g}")
    if not rel <= 1e-5:
        raise RuntimeError(f"sgd train losses disagree ({leg}): {losses}")
    if not grad_rel[worst] <= GRAD_TOL[torch.float32]:
        raise RuntimeError(f"sgd gradients disagree ({leg}): {worst} by "
                           f"{grad_rel[worst]:.3g} of its max-abs")


def phase_train_converge():
    model = tiny_llama(vocab_size=64, embed_dim=64, attention="flash",
                       device=DEV, seed=0)
    tr = Trainer(model, optimizer="adamw", learning_rate=3e-3, device=DEV,
                 **LM_KEYS)
    _kernels.reset_launch_counts()
    hist = tr.fit(SyntheticLanguageModeling(batch_size=32, seq_len=64,
                                            vocab_size=64, seed=0),
                  epochs=3, steps_per_epoch=8, verbose=0)
    loss = hist.history["loss"]
    launches = {k: _kernels.launch_counts[k] for k in FLASH_COUNTERS}
    phase("train_converge", model="tiny_llama_E64_D2_H4/2_flash",
          steps=24, epoch_losses="/".join(f"{x:.5f}" for x in loss),
          epoch_accuracy="/".join(f"{x:.4f}" for x in
                                  hist.history["accuracy"]),
          launches=launches)
    if not loss[-1] < 0.7 * loss[0]:
        raise RuntimeError(f"tiny Llama did not learn: epoch losses {loss}")
    if launches["flash_fwd"] != 2 * 24 or launches["flash_bwd_fused"] != 48:
        raise RuntimeError(f"training did not run the flash kernels: "
                           f"{launches}")


def _timed_fit(model, batch: int, seq: int, warmup: int, steps: int):
    """adamw at lr 1e-4 on the synthetic LM task: ``warmup`` steps, then
    ``steps`` timed ones (host clock around ``Trainer.fit``, ending in a
    sync) with the launch counts set to 0 just before and the peak memory
    reset. Returns the trainer, the data, the history, the wall seconds,
    the launches, tokens/s, the 6ND MFU over the non-embedding parameters
    and the peak memory."""
    n_matmul = sum(p.numel() for p in model.parameters()) \
        - model.stem.embed.weight.numel()
    tr = Trainer(model, optimizer="adamw", learning_rate=1e-4, device=DEV,
                 **LM_KEYS)
    data = SyntheticLanguageModeling(batch_size=batch, seq_len=seq,
                                     vocab_size=VOCAB, seed=0)
    tr.fit(data, epochs=1, steps_per_epoch=warmup, verbose=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = tr.fit(data.with_offset(warmup), epochs=steps, steps_per_epoch=1,
                  verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launch_counts)
    tokens_s = batch * seq * steps / wall
    mfu = 6 * n_matmul * tokens_s / PEAK_FLOPS[torch.bfloat16]
    return (tr, data, hist, wall, counts, tokens_s, mfu,
            torch.cuda.max_memory_allocated())


def _train_fields(model, batch, seq, steps, hist, wall, counts, tokens_s,
                  mfu, peak):
    n_params = sum(p.numel() for p in model.parameters())
    return dict(params=n_params,
                matmul_params=n_params - model.stem.embed.weight.numel(),
                batch=batch, seq=seq, steps=steps,
                wall_s=f"{wall:.4f}", ms_per_step=f"{1e3 * wall / steps:.3f}",
                tokens_per_s=f"{tokens_s:.2f}", mfu_6nd=f"{mfu:.4f}",
                peak_mem_gib=f"{peak / 2**30:.3f}",
                losses="/".join(f"{x:.5f}" for x in hist.history["loss"]),
                flash_per_step="/".join(f"{k}:{counts[k] / steps:g}"
                                        for k in FLASH_COUNTERS))


def phase_train_step(batch: int = 4, seq: int = 2048, warmup: int = 2,
                     steps: int = 5):
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=0)
    tr, data, hist, wall, train_counts, tokens_s, mfu, peak = _timed_fit(
        model, batch, seq, warmup, steps)
    val = tr.evaluate(data.with_offset(warmup + steps), steps=1)
    launches = dict(_kernels.launch_counts)
    losses = hist.history["loss"] + [val["loss"]]
    depth = model.depth
    phase("train_step", model="Llama_1B_bf16_compute_f32_params",
          **_train_fields(model, batch, seq, steps, hist, wall, train_counts,
                          tokens_s, mfu, peak),
          eval_loss=f"{val['loss']:.5f}",
          eval_flash_fwd_nolse=launches["flash_fwd_nolse"])
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training losses {losses}")
    want = {"flash_fwd": depth * steps, "flash_bwd_fused": depth * steps,
            "flash_fwd_nolse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    got = {k: train_counts[k] for k in want}
    if got != want or launches["flash_fwd_nolse"] != depth or any(
            launches[k] != train_counts[k] for k in ("flash_fwd",
                                                     "flash_bwd_fused")):
        raise RuntimeError(f"flash launches {train_counts} over {steps} "
                           f"steps, {launches} after one eval batch, of a "
                           f"{depth}-layer model")
    return launches, tr, data


def phase_train_long(batch: int = 1, seq: int = 8192, warmup: int = 2,
                     steps: int = 5):
    """Long-context training: full Llama-1B with ``remat="dots"`` at
    B 1 x S 8192, whose backward takes the two sweeps."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, remat="dots", dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=0)
    tr, data, hist, wall, counts, tokens_s, mfu, peak = _timed_fit(
        model, batch, seq, warmup, steps)
    depth = model.depth
    phase("train_long", model="Llama_1B_remat_dots_bf16_compute_f32_params",
          **_train_fields(model, batch, seq, steps, hist, wall, counts,
                          tokens_s, mfu, peak))
    losses = hist.history["loss"]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite long-context losses {losses}")
    # K1 runs in the forward and again in the remat recompute; the
    # backward is K3a + K3b in every layer, never K2.
    want = {"flash_fwd": 2 * depth * steps, "flash_fwd_nolse": 0,
            "flash_bwd_fused": 0, "flash_bwd_dq": depth * steps,
            "flash_bwd_dkv": depth * steps}
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"long-context launches {counts} over {steps} "
                           f"steps of a {depth}-layer model, want {want}")
    return counts, tr, data


def phase_fused_loss(seq: int = 8192, reps: int = 3):
    """``fused_lm_loss`` against the materialized logits and the trainer's
    cross-entropy on one forward+backward of Llama-1B at depth 2: the
    loss, every gradient, the ms (mean of ``reps`` after one warm-up) and
    the peak memory of each."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, depth=2, dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=3)
    batch = SyntheticLanguageModeling(batch_size=1, seq_len=seq,
                                      vocab_size=VOCAB, seed=2).batch(0)
    x = torch.as_tensor(batch["tokens"]).to(DEV)
    y = torch.as_tensor(batch["targets"]).to(DEV)
    paths = {"materialized": lambda: sparse_categorical_crossentropy(
                 model(x), y),
             "fused": lambda: fused_lm_loss(model, x, y)}
    out = {}
    for name, loss_fn in paths.items():
        model.zero_grad(set_to_none=True)
        loss_fn().backward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall = 0.0
        for _ in range(reps):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = loss_fn()
            loss.backward()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        out[name] = (loss.item(), 1e3 * wall / reps,
                     torch.cuda.max_memory_allocated(),
                     {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        del loss
    ref, got = out["materialized"], out["fused"]
    rel = abs(got[0] - ref[0]) / abs(ref[0])
    grad_rel = {n: float((got[3][n] - g).abs().max()) / float(g.abs().max())
                for n, g in ref[3].items()}
    worst = max(grad_rel, key=grad_rel.get)
    phase("fused_loss", model="Llama_1B_depth2_bf16_compute_f32_params",
          batch=1, seq=seq, loss_materialized=f"{ref[0]:.6f}",
          loss_fused=f"{got[0]:.6f}", loss_rel_diff=f"{rel:.3g}",
          max_grad_rel_diff=f"{grad_rel[worst]:.3g}", worst_leaf=worst,
          ms_materialized=f"{ref[1]:.3f}", ms_fused=f"{got[1]:.3f}",
          peak_gib_materialized=f"{ref[2] / 2**30:.3f}",
          peak_gib_fused=f"{got[2] / 2**30:.3f}")
    if not (np.isfinite(got[0]) and rel <= 2e-3):
        raise RuntimeError(f"fused loss {got[0]} vs materialized {ref[0]}")
    if not grad_rel[worst] <= GRAD_TOL[torch.bfloat16]:
        raise RuntimeError(f"fused-loss gradients disagree: {worst} by "
                           f"{grad_rel[worst]:.3g} of its max-abs")


# --------------------------------------------------------- phase 13-15
def resnet_macs(model, image: int) -> int:
    """Multiply-accumulates of one image's forward at ``image`` x
    ``image``, from the model's own conv and dense shapes: each conv's
    output elements times its ``in x kh x kw`` taps (hooks on a batch-1
    inference forward, which leaves the BatchNorm buffers alone), plus
    the head's ``in x out``."""
    macs = []
    hooks = [m.register_forward_hook(
        lambda mod, _, out: macs.append(out[0].numel()
                                        * mod.weight[0].numel()))
        for m in model.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3, device=model.device),
              train=False)
    for h in hooks:
        h.remove()
    return sum(macs) + (model.head.weight.numel() if model.num_classes
                        else 0)


def phase_resnet_parity(steps: int = 3, lr: float = 0.005, batch: int = 4):
    """Full-width, full-depth ResNet-50 in f32 (TF32 off, cuDNN's
    algorithm search off), one seeded weight set trained by the port's
    Trainer on the card (cuDNN/ATen) and on the CPU with SGD at
    ``_train_1step``'s rate and the gradient norm logged, for each stem.

    First ``steps`` free-running steps on each side, printed: a BatchNorm
    net at init amplifies the two sides' rounding (cuDNN's and oneDNN's
    convs differ by ~1e-7), so after the first step the runs part, as
    ``__graft_entry__._train_1step`` notes of multi-step trajectories;
    only the first step is gated. Then ``steps`` steps each from one
    state, the CPU model's copied to the card, all gated: losses within
    rtol 1e-4, gradient norms within 1e-3 relative, parameters within
    2·lr·steps, each BatchNorm buffer within 1e-4 of its max-abs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    data = SyntheticImageClassification(batch_size=batch, image_size=224,
                                        num_classes=1000, seed=1)
    for stem in ("keras", "space_to_depth"):
        cpu_model = ResNet50(num_classes=1000, stem=stem, device="cpu",
                             seed=3)
        gpu_model = ResNet50(num_classes=1000, stem=stem, device=DEV)
        gpu_model.load_state_dict(cpu_model.state_dict())
        trainers = {m: Trainer(m, optimizer="sgd", learning_rate=lr,
                               log_grad_norm=True, device=m.device)
                    for m in (gpu_model, cpu_model)}
        free = {"loss": [], "grad_norm": []}
        synced = {"loss": [], "grad_norm": [], "param": [], "buffer": []}
        for step in range(2 * steps):
            if step >= steps:  # from here on each step starts from one state
                gpu_model.load_state_dict(cpu_model.state_dict())
            b = data.batch(step)
            g, c = (trainers[m].train_step(b) for m in (gpu_model, cpu_model))
            rel = {k: abs(float(g[k]) - float(c[k])) / abs(float(c[k]))
                   for k in ("loss", "grad_norm")}
            out = free if step < steps else synced
            for k in rel:
                out[k].append((float(g[k]), float(c[k]), rel[k]))
            if step < steps:
                continue
            cpu_sd = cpu_model.state_dict()
            synced["param"].append(max(
                float((p.detach().cpu() - cpu_sd[n]).abs().max())
                for n, p in gpu_model.named_parameters()))
            synced["buffer"].append(max(
                (float((b_.cpu() - cpu_sd[n]).abs().max())
                 / float(cpu_sd[n].abs().max()), n)
                for n, b_ in gpu_model.named_buffers()))

        def seq(rows, i, fmt):
            return "/".join(format(r[i], fmt) for r in rows)

        worst = {k: max(r[2] for r in synced[k])
                 for k in ("loss", "grad_norm")}
        buf_rel, buf_name = max(synced["buffer"])
        param_diff = max(synced["param"])
        phase("resnet_parity", model="ResNet50_f32", stem=stem,
              allow_tf32=False, cudnn_benchmark=False, batch=batch,
              image=224, optimizer="sgd", lr=lr,
              free_losses_cuda=seq(free["loss"], 0, ".7f"),
              free_losses_cpu=seq(free["loss"], 1, ".7f"),
              free_grad_norms_cuda=seq(free["grad_norm"], 0, ".5f"),
              free_grad_norms_cpu=seq(free["grad_norm"], 1, ".5f"),
              free_loss_rel_diffs=seq(free["loss"], 2, ".3g"),
              free_grad_norm_rel_diffs=seq(free["grad_norm"], 2, ".3g"),
              synced_steps=steps,
              synced_losses_cuda=seq(synced["loss"], 0, ".7f"),
              synced_losses_cpu=seq(synced["loss"], 1, ".7f"),
              max_loss_rel_diff=f"{worst['loss']:.3g}", loss_rtol="1e-4",
              max_grad_norm_rel_diff=f"{worst['grad_norm']:.3g}",
              grad_norm_rtol="1e-3", max_param_diff=f"{param_diff:.3g}",
              param_bound=f"{2 * lr * steps:g}",
              max_buffer_rel_diff=f"{buf_rel:.3g}", worst_buffer=buf_name,
              buffer_bound="1e-4 of its max-abs")
        first = {k: free[k][0][2] for k in ("loss", "grad_norm")}
        if not (first["loss"] <= 1e-4 and worst["loss"] <= 1e-4):
            raise RuntimeError(f"ResNet-50 losses disagree ({stem}): "
                               f"{free['loss']} {synced['loss']}")
        if not (first["grad_norm"] <= 1e-3 and worst["grad_norm"] <= 1e-3):
            raise RuntimeError(f"ResNet-50 gradient norms disagree ({stem})"
                               f": {free['grad_norm']} "
                               f"{synced['grad_norm']}")
        if not param_diff <= 2 * lr * steps:
            raise RuntimeError(f"ResNet-50 parameters differ by "
                               f"{param_diff} ({stem})")
        if not buf_rel <= 1e-4:
            raise RuntimeError(f"ResNet-50 BatchNorm buffer {buf_name} "
                               f"differs by {buf_rel:.3g} of its max-abs")
        del cpu_model, gpu_model, trainers


def phase_resnet_converge(epochs: int = 8, steps: int = 16):
    """``tiny_resnet`` through ``Trainer.fit`` with the reference's
    augmentation and eval transform at 32x32, validation data and the
    reference's two callbacks (shortened patience). BatchNorm momentum
    0.5: at Keras' 0.99 the running averages of a 100-step run still
    carry their initial values, and the validation loss would measure
    that (``pddl_tpu/models/resnet.py``'s note on ``bn_momentum``)."""
    model = tiny_resnet(num_classes=10, bn_momentum=0.5, device=DEV, seed=0)
    tr = Trainer(model, optimizer="momentum", learning_rate=0.05,
                 device=DEV, augment=standard_augment(crop=32),
                 eval_transform=standard_eval_transform(crop=32))
    data = SyntheticImageClassification(batch_size=32, image_size=32,
                                        num_classes=10, seed=0)
    plateau = ReduceLROnPlateau(factor=0.5, patience=1)
    stop = EarlyStopping(patience=2, restore_best_weights=True)
    hist = tr.fit(data, epochs=epochs, steps_per_epoch=steps,
                  validation_data=data.with_offset(10**6),
                  validation_steps=2, callbacks=[plateau, stop], verbose=0)
    h = hist.history
    phase("resnet_converge", model="tiny_resnet_bn_momentum_0.5",
          image=32, batch=32, steps_per_epoch=steps,
          epochs_run=len(h["loss"]), stopped_epoch=stop.stopped_epoch,
          final_lr=f"{tr.optimizer.param_groups[0]['lr']:g}",
          epoch_losses="/".join(f"{x:.4f}" for x in h["loss"]),
          val_losses="/".join(f"{x:.4f}" for x in h["val_loss"]),
          val_accuracy="/".join(f"{x:.4f}" for x in h["val_accuracy"]))
    if not h["loss"][-1] < 0.7 * h["loss"][0]:
        raise RuntimeError(f"tiny ResNet did not learn: {h['loss']}")


def _timed_resnet(stem: str, batch: int, warmup: int, steps: int,
                  image: int = 224):
    """``bench.py``'s step through ``Trainer.train_step``: ResNet-50, bf16
    compute over f32 parameters, BatchNorm in train mode, adam at 1e-3,
    on a batch resident on the card; ``warmup`` steps, then ``steps``
    timed ones (host clock, ending in a sync)."""
    torch.cuda.empty_cache()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, stem=stem,
                     device=DEV, seed=0)
    macs = resnet_macs(model, image)
    tr = Trainer(model, optimizer="adam", learning_rate=1e-3, metrics=(),
                 device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    batch_d = {"image": torch.randn(batch, image, image, 3, generator=gen,
                                    device=DEV),
               "label": torch.randint(0, 1000, (batch,), generator=gen,
                                      device=DEV, dtype=torch.int32)}
    for _ in range(warmup):
        tr.train_step(batch_d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = tr.train_step(batch_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = float(logs["loss"])
    images_s = batch * steps / wall
    flops = 6 * macs  # 2 x MACs forward, x 3 for forward + backward
    fields = dict(model="ResNet50_bf16_compute_f32_params", stem=stem,
                  bn_mode="train", optimizer="adam", lr=1e-3, batch=batch,
                  image=image, warmup=warmup, steps=steps,
                  cudnn_benchmark=torch.backends.cudnn.benchmark,
                  wall_s=f"{wall:.4f}", ms_per_step=f"{1e3 * wall / steps:.3f}",
                  images_per_s=f"{images_s:.2f}",
                  peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                  last_loss=f"{loss:.5f}", fwd_gmac_per_image=f"{macs / 1e9:.4f}",
                  train_gflop_per_image=f"{flops / 1e9:.4f}",
                  mfu=f"{flops * images_s / PEAK_FLOPS[torch.bfloat16]:.4f}")
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite ResNet-50 loss {loss} ({stem})")
    return tr, batch_d, fields


def phase_resnet_train(batch: int = 256):
    """``bench.py``'s configuration at B 256 x 224: a shorter leg with the
    Keras stem (2 warm-up and 10 timed steps), then the space-to-depth
    stem (bench.py's default; 3 warm-up and 20 timed steps), whose trainer
    and batch it returns. cuDNN's algorithm search is on
    (``torch.backends.cudnn.benchmark = True``): every step has the same
    shapes, so the search runs in the warm-up."""
    torch.backends.cudnn.benchmark = True
    _, _, fields = _timed_resnet("keras", batch, 2, 10)
    phase("resnet_train", **fields)
    tr, batch_d, fields = _timed_resnet("space_to_depth", batch, 3, 20)
    phase("resnet_train", **fields)
    return tr, batch_d


# Kernel classes of the ResNet step's profile, by kernel name; the first
# class whose words appear in a kernel's name takes it. The generic
# elementwise class holds the conv biases' adds (cuDNN adds the bias in a
# kernel of its own), the ReLUs, the residual adds and the casts.
RESNET_CLASSES = (
    ("batchnorm", ("batch_norm",)),
    ("adam", ("multi_tensor_apply",)),
    ("pooling", ("pool",)),
    ("reductions_and_loss", ("reduce_kernel", "softmax", "SoftMax", "nll")),
    ("elementwise_and_casts", ("elementwise", "copy", "fill", "Memset")),
    ("convolutions_and_gemm", ("conv", "xmma", "cudnn", "cutlass", "gemm",
                               "nvjet", "nhwc", "implicit")),
)


def profile_resnet(tr, batch_d, out_dir: str) -> None:
    """``--profile``: one ResNet-50 train step under ``torch.profiler``:
    its wall time, the device-busy share, device time by kernel class
    (convolutions, BatchNorm, elementwise and casts, adam, ...) and the
    largest kernels; the whole kernel table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch_d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    by_class, other = {}, {}
    for e in kern:
        cls = next((c for c, words in RESNET_CLASSES
                    if any(w in e.key for w in words)), "other")
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / 1e3, n + e.count)
        if cls == "other":
            other[e.key[:50]] = e.self_device_time_total / 1e3
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / "profile_resnet.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=80))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / 1e3:.3f}ms"
                   f"x{e.count}" for e in kern[:10])
    phase("profile_resnet", model="ResNet50_bf16_s2d", batch=len(
              batch_d["label"]), step_ms=f"{1e3 * wall:.3f}",
          device_busy_ms=f"{busy_us / 1e3:.3f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          by_class=";".join(f"{c}:{ms:.3f}ms/{n}" for c, (ms, n) in
                            sorted(by_class.items(), key=lambda x: -x[1][0])),
          other=";".join(f"{k}:{v:.3f}ms" for k, v in other.items()),
          top_kernels=top)


def profile_train(tr, data, out_dir: str, tag: str = "train") -> None:
    """``--profile``: one train step under ``torch.profiler``: its wall
    time, the device-busy share and the largest kernels by device time;
    the whole kernel table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(data.batch(100))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / f"profile_{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / 1e3:.2f}ms"
                   f"x{e.count}" for e in kern[:12])
    phase(f"profile_{tag}", step_ms=f"{1e3 * wall:.3f}",
          device_busy_ms=f"{busy_us / 1e3:.3f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          top_kernels=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile a window of decode ticks after "
                         "phase 7 and one train step after each of phases "
                         "10, 11 and 15, and write their kernel tables to "
                         "DIR")
    args = ap.parse_args(argv)
    smi = device_line()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    phase("build", kernels=",".join(_kernels.SOURCES),
          seconds=f"{build_kernels():.2f}")
    timing = {"paged_decode": phase_paged_decode(), **phase_flash_fwd(),
              "flash_bwd_fused": phase_flash_bwd(),
              **phase_flash_bwd_two_sweep()}
    phase_engine_parity()
    serve_launches, model, prompts = phase_engine_serve()
    if args.profile:
        profile_decode(model, prompts, args.profile)
    del model
    phase_train_parity()
    phase_train_converge()
    train_launches, tr, data = phase_train_step()
    if args.profile:
        profile_train(tr, data, args.profile)
    del tr, data
    long_launches, tr, data = phase_train_long()
    if args.profile:
        profile_train(tr, data, args.profile, tag="train_long")
    del tr, data
    phase_fused_loss()
    phase_resnet_parity()
    phase_resnet_converge()
    tr, batch_d = phase_resnet_train()
    if args.profile:
        profile_resnet(tr, batch_d, args.profile)
    del tr, batch_d
    src = "pddl_tpu_torch/ops/csrc/"
    att = "pddl_tpu/ops/attention.py:"
    # (name, source, TPU kernel's line, launches on the main path: the
    # serve run, the train step with its eval batch, or the long-context
    # run; K1 with the LSE runs on both training paths).
    rows = [
        ("paged_decode", "paged_decode.cu", 1221,
         serve_launches["paged_decode"]),
        ("flash_fwd", "flash_fwd.cu", 183,
         train_launches["flash_fwd"] + long_launches["flash_fwd"]),
        ("flash_fwd_nolse", "flash_fwd.cu", 389,
         train_launches["flash_fwd_nolse"]),
        ("flash_bwd_fused", "flash_bwd.cu", 617,
         train_launches["flash_bwd_fused"]),
        ("flash_bwd_dq", "flash_bwd.cu", 551, long_launches["flash_bwd_dq"]),
        ("flash_bwd_dkv", "flash_bwd.cu", 578,
         long_launches["flash_bwd_dkv"]),
    ]
    kernels = [{"name": name, "route": "cuda", "source": src + file,
                "replaces": f"{att}{line}", "launches": launches,
                **timing[name]} for name, file, line, launches in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
