"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout on a machine with a card and the CUDA
toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, drives the two main paths of the
port on a full-width Llama-1B — the paged serving engine and the
causal-LM trainer — and prints one line per phase:

1. device — ``nvidia-smi``'s card name and power limit;
2. build — every kernel compiled by ``nvcc``, one process per source, all
   started together (seconds);
3. paged_decode vs plain — max-abs error at Llama-1B's decode shape
   (bf16 and f32, with and without a window), an odd shape (rep 3,
   D 128) and the CPU tests' tiny shape; then the kernel's time, the
   plain version's, an SDPA yardstick's and the bound, on CUDA events;
4. flash_fwd vs plain — K1 with and without its LSE write at Llama-1B's
   training shape (B 4, H 32/8, S 2048, D 64, bf16, causal), with a
   512 window, MHA, rep 3 at D 128, a ragged S of 1000, offset keys and
   f32; then times and bound at the Llama-1B shape (SDPA the yardstick);
5. flash_bwd vs plain — K2's dq, dk, dv at the same shapes (two of them
   with an LSE cotangent too), relative to each gradient's max-abs; then
   times and bound (SDPA forward+backward minus forward the yardstick);
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
   max-abs: the check that holds K2's gradients on the training path);
9. train converge — a width-64 tiny Llama with flash attention learns
   the synthetic next-token task on the card (last loss < 0.7 x first);
10. train step — full-width, full-depth Llama-1B, bf16 compute over f32
    parameters, adamw, B 4 x S 2048: 2 warm-up then 5 timed steps through
    ``Trainer.fit`` and one ``evaluate`` batch: tokens/s, ms/step, 6ND
    MFU, peak device memory, the losses, and the launches of each flash
    kernel (the training path's launches);
11. kernels — one JSON object: every ported kernel with its launches on
    its main path (phase 7 or 10), error, times and bound;

and, as its last line, ``{"ok": true, "device": {...}}``. Any failure
raises: the script exits non-zero and prints no result. It needs the
repository beside it and a card (``torch.cuda.is_available()``).
``--profile DIR`` adds a profiled decode window after phase 7 and a
profiled train step after phase 10, and writes their kernel tables to
DIR.
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

from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.llama import Llama_1B, tiny_llama
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import FinishReason
from pddl_tpu_torch.train.loop import Trainer

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


def flash_fwd_bound_ms(q, k):
    """Least time of one causal forward and what sets it: 2·B·H·S²·D
    flops over the bf16 tensor-core peak, or the bytes of q, k, v read
    once and o and lse written once over HBM bandwidth."""
    b, h, s, d = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + b * h * s * 4
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

    # Times at Llama-1B's training shape: two input sets (~100 MB).
    cases = [flash_case(gen, *FLASH_CASES["llama1b"]) for _ in range(2)]
    kw = cases[0][3]
    ms = cuda_ms(lambda i: tatt.flash_forward(*cases[i][0], **kw), 2,
                 iters=20)
    ms_nolse = cuda_ms(lambda i: tatt.flash_forward(
        *cases[i][0], want_lse=False, **kw), 2, iters=20)
    plain_ms = cuda_ms(lambda i: tatt.flash_forward_plain(*cases[i][0], **kw),
                       2, iters=4)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        *cases[i][0], is_causal=True, enable_gqa=True), 2, iters=20)
    bound_ms, bound_by = flash_fwd_bound_ms(*cases[0][0][:2])
    phase("flash_fwd_time", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          ms=f"{ms:.5f}", ms_nolse=f"{ms_nolse:.5f}",
          plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
          bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    err = max(e for k, (e, _) in errs.items() if k.startswith("llama1b_"))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "max_abs_err": err}


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
    kern = device_kernels(prof)
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


# ---------------------------------------------------------- phase 8-10
FLASH_COUNTERS = ("flash_fwd", "flash_fwd_nolse", "flash_bwd_fused")
LM_KEYS = dict(input_key="tokens", target_key="targets")


def _train_both(optimizer: str, lr: float, steps: int):
    """One seeded Llama-1B (depth 2, f32) trained ``steps`` steps by the
    port's Trainer on the card (kernels) and on the CPU (plain versions),
    on the same batches. Returns the per-step losses of each, their
    largest relative difference and, per parameter, the card's and the
    CPU's trained value and last step's gradient."""
    cfg = dict(vocab_size=VOCAB, depth=2, dtype=torch.float32)
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
    losses, rel, params = _train_both("sgd", sgd_lr, steps)
    grad_rel = {}
    for name, (_, _, g, c) in params.items():
        scale = float(c.abs().max())
        if scale == 0.0:
            raise RuntimeError(f"{name} has a zero gradient on the CPU")
        grad_rel[name] = float((g - c).abs().max()) / scale
    worst = max(grad_rel, key=grad_rel.get)
    phase("train_parity", model="Llama_1B_depth2_f32", allow_tf32=False,
          optimizer="sgd", lr=sgd_lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}",
          max_grad_rel_diff=f"{grad_rel[worst]:.3g}", worst_leaf=worst,
          grad_bound=f"{GRAD_TOL[torch.float32]:g}")
    if not rel <= 1e-5:
        raise RuntimeError(f"sgd train losses disagree: {losses}")
    if not grad_rel[worst] <= GRAD_TOL[torch.float32]:
        raise RuntimeError(f"sgd gradients disagree: {worst} by "
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


def phase_train_step(batch: int = 4, seq: int = 2048, warmup: int = 2,
                     steps: int = 5):
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.stem.embed.weight.numel()
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
    train_counts = dict(_kernels.launch_counts)
    val = tr.evaluate(data.with_offset(warmup + steps), steps=1)
    launches = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    losses = hist.history["loss"] + [val["loss"]]
    tokens_s = batch * seq * steps / wall
    mfu = 6 * n_matmul * tokens_s / PEAK_FLOPS[torch.bfloat16]
    depth = model.depth
    phase("train_step", model="Llama_1B_bf16_compute_f32_params",
          params=n_params, matmul_params=n_matmul, batch=batch, seq=seq,
          steps=steps, wall_s=f"{wall:.4f}",
          ms_per_step=f"{1e3 * wall / steps:.3f}",
          tokens_per_s=f"{tokens_s:.2f}", mfu_6nd=f"{mfu:.4f}",
          peak_mem_gib=f"{peak / 2**30:.3f}",
          losses="/".join(f"{x:.5f}" for x in hist.history["loss"]),
          eval_loss=f"{val['loss']:.5f}",
          flash_per_step="/".join(
              f"{k}:{train_counts[k] / steps:g}" for k in FLASH_COUNTERS),
          eval_flash_fwd_nolse=launches["flash_fwd_nolse"])
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training losses {losses}")
    want = {"flash_fwd": depth * steps, "flash_bwd_fused": depth * steps,
            "flash_fwd_nolse": 0}
    got = {k: train_counts[k] for k in want}
    if got != want or launches["flash_fwd_nolse"] != depth or any(
            launches[k] != train_counts[k] for k in ("flash_fwd",
                                                     "flash_bwd_fused")):
        raise RuntimeError(f"flash launches {train_counts} over {steps} "
                           f"steps, {launches} after one eval batch, of a "
                           f"{depth}-layer model")
    return launches, tr, data


def profile_train(tr, data, out_dir: str) -> None:
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
    (pathlib.Path(out_dir) / "profile_train.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / 1e3:.2f}ms"
                   f"x{e.count}" for e in kern[:10])
    phase("profile_train", step_ms=f"{1e3 * wall:.3f}",
          device_busy_ms=f"{busy_us / 1e3:.3f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          top_kernels=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile a window of decode ticks after "
                         "phase 7 and one train step after phase 10, and "
                         "write their kernel tables to DIR")
    args = ap.parse_args(argv)
    smi = device_line()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    phase("build", kernels=",".join(_kernels.SOURCES),
          seconds=f"{build_kernels():.2f}")
    timing = {"paged_decode": phase_paged_decode(),
              "flash_fwd": phase_flash_fwd(),
              "flash_bwd_fused": phase_flash_bwd()}
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
    src = "pddl_tpu_torch/ops/csrc/"
    kernels = [
        {"name": "paged_decode", "route": "cuda",
         "source": src + "paged_decode.cu",
         "replaces": "pddl_tpu/ops/attention.py:1221",
         "launches": serve_launches["paged_decode"],
         **timing["paged_decode"]},
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": "pddl_tpu/ops/attention.py:183",
         "launches": (train_launches["flash_fwd"]
                      + train_launches["flash_fwd_nolse"]),
         **timing["flash_fwd"]},
        {"name": "flash_bwd_fused", "route": "cuda",
         "source": src + "flash_bwd.cu",
         "replaces": "pddl_tpu/ops/attention.py:617",
         "launches": train_launches["flash_bwd_fused"],
         **timing["flash_bwd_fused"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
