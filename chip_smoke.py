"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout on a machine with a card and the CUDA
toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, drives the paged serving engine
on a full-width Llama-1B and prints one line per phase:

1. device — ``nvidia-smi``'s card name and power limit;
2. build — every kernel compiled by ``nvcc`` (seconds);
3. paged_decode vs plain — max-abs error at Llama-1B's decode shape
   (bf16 and f32, with and without a window), an odd shape (rep 3,
   D 128) and the CPU tests' tiny shape; then the kernel's time, the
   plain version's, an SDPA yardstick's and the bound, on CUDA events;
4. engine parity — full-width Llama-1B at depth 2 in f32 (TF32 off), one
   seeded weight set in an engine on the card (kernel) and one on the
   CPU (plain version), 4 greedy requests x 16 tokens, token-exact
   unless the CPU's top-2 logit margin at the divergence is < 1e-3 (a
   tie);
5. engine serve — full-width, full-depth Llama-1B in bf16, 24 requests
   of 384 prompt tokens (256 shared) x 32 new tokens on 8 slots:
   tokens/s, TTFT p50, peak device memory;
6. kernels — one JSON object: every ported kernel with its launches on
   the main path (phase 5), error, times and bound;

and, as its last line, ``{"ok": true, "device": {...}}``. Any failure
raises: the script exits non-zero and prints no result. It needs the
repository beside it and a card (``torch.cuda.is_available()``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from pddl_tpu_torch.models.llama import Llama_1B
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import FinishReason

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
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
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = flops / PEAK_FLOPS[q.dtype]
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


def phase_paged_decode():
    gen = torch.Generator(device=DEV).manual_seed(0)
    llama = dict(b=8, h=32, hkv=8, d=64, bs=16, t=64,
                 depths=[0, 7, 16, 100, 391, 512, 777, 64 * 16 - 1])
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
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("paged_decode", cases=len(errs),
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, (e, tol)
                          in errs.items()))
    if bad:
        raise RuntimeError(f"paged_decode kernel disagrees with plain: {bad}")

    # Timing at the engine's decode shape (bf16, no window); 8 copies of
    # the pools (~134 MB) so every launch reads K/V from HBM.
    cases = [paged_case(gen, dtype=torch.bfloat16, **llama)
             for _ in range(8)]
    ms = cuda_ms(lambda i: tatt.paged_decode_attention_kernel(*cases[i]), 8)
    plain_ms = cuda_ms(lambda i: tatt.paged_decode_attention(
        *cases[i], kernel=False), 8, iters=50)
    library_ms = cuda_ms(sdpa_fn(cases), 8)
    bound_ms, bound_by = decode_bound_ms(cases[0])
    err = max(e for k, (e, _) in errs.items() if k.startswith("llama1b_bf16"))
    timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "max_abs_err": err}
    phase("paged_decode_time", shape="B8_H32_Hkv8_D64_bs16_T64_bf16",
          depths="/".join(map(str, llama["depths"])), ms=f"{ms:.5f}",
          plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
          bound_ms=f"{bound_ms:.5f}")
    return timing


# -------------------------------------------------------------- phase 4
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


# -------------------------------------------------------------- phase 5
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


def profile_decode(model, prompts, out_dir: str, n_ticks: int = 8) -> None:
    """``--profile``: the wall time of one step that admits 8 requests,
    then a window of steady decode ticks (8 slots live at depth ~390)
    under ``torch.profiler``. Prints the tick's wall time, the
    device-busy share of the window and the largest kernels by device
    time; writes the whole kernel table to ``out_dir``."""
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
    cuda = torch.autograd.DeviceType.CUDA
    kern = sorted((e for e in prof.key_averages() if e.device_type == cuda),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kern)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / "profile_decode.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / n_ticks:.1f}us"
                   f"x{e.count // n_ticks}" for e in kern[:8])
    phase("profile_decode", admit_step_ms=f"{admit_ms:.4f}", ticks=n_ticks,
          tick_ms=f"{1e3 * wall / n_ticks:.4f}",
          device_busy_ms_per_tick=f"{busy_us / 1e3 / n_ticks:.4f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          top_kernels_per_tick=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile a window of decode ticks after "
                         "phase 5 and write its kernel table to DIR")
    args = ap.parse_args(argv)
    smi = device_line()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    phase("build", kernels=",".join(_kernels.SOURCES),
          seconds=f"{build_kernels():.2f}")
    timing = phase_paged_decode()
    phase_engine_parity()
    launches, model, prompts = phase_engine_serve()
    if args.profile:
        profile_decode(model, prompts, args.profile)
    kernels = [{"name": "paged_decode", "route": "cuda",
                "source": "pddl_tpu_torch/ops/csrc/paged_decode.cu",
                "replaces": "pddl_tpu/ops/attention.py:1221",
                "launches": launches["paged_decode"], **timing}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
