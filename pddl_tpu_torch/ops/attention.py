"""Attention ops of the port, in PyTorch (subset of
:mod:`pddl_tpu.ops.attention`).

- :func:`attention_reference` — plain causal GQA softmax attention, the
  numerics oracle.
- :func:`flash_attention` / :func:`flash_attention_lse` — the training
  path's attention, with the JAX package's signatures: the same window
  rules, power-of-two scale fold and fused-backward test. Unlike the
  Pallas kernels, which need blocks that divide the length, these pick
  their own tiles (64 keys; 128 query rows for K1 and K3a in bf16, 64
  otherwise) and mask ragged edges, so every length runs the kernels (the
  JAX package's reference fallback for degenerate tilings has no
  counterpart; ``block_q``/``block_k`` are accepted and ignored). The
  forward is the hand-written K1 (:func:`flash_forward`,
  ``csrc/flash_fwd.cu``); under a gradient, a ``torch.autograd.Function``
  saves ``(q, k, v, o, lse)`` and its backward (:func:`flash_backward`,
  ``csrc/flash_bwd.cu``) is the fused K2, or the two sweeps K3a (dq) and
  K3b (dk/dv) where the JAX package's dispatch takes them (long
  sequences). Each kernel's plain
  version (:func:`flash_forward_plain`, :func:`flash_backward_plain`)
  sits beside it and runs only for CPU tensors.
- :func:`decode_attention` — attention over a ROW cache (``generate``
  and the resident-row engine): a scalar or per-row index, a window, a
  rolling ring, ``history_only`` and the LSE, read over the live prefix
  only; plain PyTorch on every device, as the JAX package leaves it to
  XLA. Beside it the row and block copies :func:`cache_slot_insert`,
  :func:`cache_slot_reset`, :func:`cache_blocks_gather` and
  :func:`cache_blocks_scatter`, which write in place.
- :func:`paged_cache_insert` — write the current token(s) of every row
  into its table-mapped pool block.
- :func:`paged_decode_attention` — attention over the pool through a
  per-row block table. Its plain path (torch ops) serves multi-token
  prefill chunks on every device and single-token steps on the CPU; a
  single-token step on a CUDA tensor goes to the hand-written kernel
  (:func:`paged_decode_attention_kernel`, ``csrc/paged_decode.cu``).

Safety contract shared with ``serve/kvcache/block_pool.py``: block 0 is
the reserved scratch sink — parked rows' table entries are all scratch,
junk writes land there, and masked reads never reach past a row's
position counter, so scratch content is junk by construction and
harmless by masking.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pddl_tpu_torch.ops import _kernels

NEG_INF = -1e30

IndexLike = Union[int, torch.Tensor]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def host_index(index) -> Union[int, torch.SymInt]:
    """A shared cache position as a host int. A ``torch.SymInt`` (the
    position of a traced decode step, ``ckpt/export.py``) passes through
    as it is, so a trace keeps it symbolic instead of specializing it."""
    return index if isinstance(index, torch.SymInt) else int(index)


def _gqa_rep(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query heads per K/V head (``[..., H, S, D]`` layouts)."""
    hq, hkv = q.shape[-3], k.shape[-3]
    if hq == hkv:
        return 1
    if hq % hkv:
        raise ValueError(
            f"query heads {hq} not divisible by kv heads {hkv}")
    return hq // hkv


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None, k_offset: int = 0,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain softmax attention over ``[B, H, S, D]`` queries and
    ``[B, H_kv, S, D]`` keys/values (GQA unexpanded: each kv head serves
    ``H/H_kv`` consecutive query heads), computed in f32. ``k_offset``
    shifts every key's position for the causal mask (ring attention's
    rotated K/V slices). ``window`` (causal only): query t sees keys
    ``[t-window+1, t]``."""
    b, h, sq, d = q.shape
    sk = k.shape[-2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "attention is a causal-LM construct)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    rep = _gqa_rep(q, k)
    hkv = k.shape[-3]
    qg = q.reshape(b, hkv, rep, sq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :] + k_offset
        mask = q_pos >= k_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


# ----------------------------------------------------------- flash attention
# The JAX package's dispatch between the fused backward (K2) and the
# two-sweep one (K3a/K3b): rep·Sq·D·4 bytes of dq accumulator. It sized a
# TPU VMEM scratch there; it is kept here so that both packages take the
# same branch at the same shape. Read at call time (tests patch it).
_FUSED_BWD_DQ_BYTES = 6 * 1024 * 1024


def _normalize_window(window: Optional[int], causal: bool, sk: int,
                      k_offset: int = 0) -> Optional[int]:
    """Validate a sliding-window width; ``window >= sk`` with aligned keys
    degrades to plain causal (None)."""
    if window is None:
        return None
    if not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is a causal-LM construct)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    window = int(window)
    return None if (window >= sk and k_offset == 0) else window


def _fold_scale(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """Fold a power-of-two softmax scale into q (exact in any binary float
    type), so the kernels skip the multiply; other scales stay in-kernel."""
    m, _ = math.frexp(scale)
    if m == 0.5:
        return q * scale, 1.0
    return q, scale


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    interpret: Optional[bool] = None,
                    fused_backward: bool = True) -> torch.Tensor:
    """Flash attention over ``q [B, H, Sq, D]`` and grouped (unexpanded)
    ``k, v [B, H_kv, Sk, D]``; returns ``o`` in q's dtype.

    With no gradient to take (``torch.is_grad_enabled()`` false, or no
    input requiring grad) this launches K1 without its LSE write; under a
    gradient it runs K1 with the LSE and the backward of
    :func:`flash_backward` (K2, or K3a and K3b). ``window``
    (causal only): query t sees keys ``[t-window+1, t]``.
    ``block_q``/``block_k`` are accepted for the JAX signature and ignored:
    the kernels pick their own tiles at every length; so is ``interpret``,
    the Pallas interpret-mode switch, which a CUDA kernel has no use for.
    ``fused_backward=False`` takes :func:`attention_reference` instead, as
    the JAX package does: O(S²) memory, and autograd differentiates it to
    any order (the kernels' backward is first-order only).
    """
    d, sk = q.shape[-1], k.shape[-2]
    _gqa_rep(q, k)
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    window = _normalize_window(window, causal, sk)
    if not fused_backward:
        return attention_reference(q, k, v, causal=causal, scale=scale_v,
                                   window=window)
    q, scale_v = _fold_scale(q, scale_v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, scale_v, window, 0)
    o, _ = flash_forward(q, k, v, causal=causal, scale=scale_v,
                         window=window, want_lse=False)
    return o


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None, k_offset: int = 0,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        interpret: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row logsumexp:
    ``(o [B, H, Sq, D], lse [B, H, Sq] f32)``, differentiable through
    both (the LSE cotangent folds into the backward's row term).
    ``k_offset`` shifts every key's position for the causal/window mask
    (ring attention's rotations). ``block_q``, ``block_k`` and
    ``interpret`` are accepted for the JAX signature and ignored."""
    d, sk = q.shape[-1], k.shape[-2]
    _gqa_rep(q, k)
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    window = _normalize_window(window, causal, sk, k_offset)
    q, scale_v = _fold_scale(q, scale_v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        return _FlashLse.apply(q, k, v, causal, scale_v, window, k_offset)
    return flash_forward(q, k, v, causal=causal, scale=scale_v,
                         window=window, k_offset=k_offset)


def _flash_scores(q, k, causal, scale, window, k_offset):
    """``scale·q·kᵀ`` in f32 as ``[B, H_kv, rep, Sq, Sk]``, masked to
    NEG_INF where key ``j + k_offset`` is after query ``i`` (or outside
    the window) — the kernels' mask, written out."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    if scale != 1.0:
        s = s * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :] + k_offset
        mask = q_pos >= k_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
    return s


def _by_kv_head(fn, q, k, v, *rows, **kw):
    """Run a plain version one kv head's query group at a time and join
    the parts along the head axis: the same function, with its f32
    ``[B, rep, Sq, Sk]`` intermediates bounded by one group (long
    sequences). ``rows`` are ``[B, H, ...]`` tensors (or None) sliced with
    q; outputs with q's head count join at H, the others at H_kv."""
    hkv = k.shape[1]
    rep = q.shape[1] // hkv
    parts = []
    for g in range(hkv):
        qs = slice(g * rep, (g + 1) * rep)
        parts.append(fn(q[:, qs], k[:, g:g + 1], v[:, g:g + 1],
                        *(None if x is None else x[:, qs] for x in rows),
                        **kw))
    return tuple(torch.cat(x, dim=1) for x in zip(*parts))


def flash_forward_plain(q, k, v, *, causal: bool, scale: float,
                        window: Optional[int] = None, k_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1: ``(o, lse)`` from one masked softmax in
    f32, with the kernel's rounding point (p rounded to v's dtype before
    the P·V product, the denominator summed in f32); one kv head's group
    at a time."""
    kw = dict(causal=causal, scale=scale, window=window, k_offset=k_offset)
    if k.shape[1] > 1:
        return _by_kv_head(flash_forward_plain, q, k, v, **kw)
    b, h, sq, d = q.shape
    s = _flash_scores(q, k, causal, scale, window, k_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(),
                     v.float()) / l
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return o.reshape(b, h, sq, d).to(q.dtype), lse


def flash_backward_plain(q, k, v, o, lse, do, dlse=None, *, causal: bool,
                         scale: float, window: Optional[int] = None,
                         k_offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K2 and of the two sweeps K3a (its ``dq``) and
    K3b (its ``dk, dv``), which compute the same function: ``(dq, dk, dv)``
    by the kernels' formulas written out, not by autograd —
    ``p = exp(s − lse)``, ``dp = do·vᵀ``,
    ``di = rowsum(do⊙o) − dlse``, ``ds = p·(dp − di)``, ``dv = pᵀ·do``,
    ``dk = scale·dsᵀ·q``, ``dq = scale·ds·k`` — with its rounding points
    (p to do's dtype, ds to q's and k's) and dk/dv summed over each kv
    head's query group; one group at a time."""
    return _backward_plain(q, k, v, lse, do, _row_term(o, do, dlse),
                           causal=causal, scale=scale, window=window,
                           k_offset=k_offset)


def _row_term(o, do, dlse=None) -> torch.Tensor:
    """The backward's row term ``di = rowsum(do⊙o) − dlse``, ``[B, H, Sq]``
    f32 — computed outside the kernels, as the JAX package computes it in
    XLA."""
    di = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.float()
    return di.contiguous()


def _backward_plain(q, k, v, lse, do, di, *, causal, scale, window,
                    k_offset):
    """:func:`flash_backward_plain` from the row term ``di``."""
    if k.shape[1] > 1:
        return _by_kv_head(_backward_plain, q, k, v, lse, do, di,
                           causal=causal, scale=scale, window=window,
                           k_offset=k_offset)
    b, h, sq, d = q.shape
    s = _flash_scores(q, k, causal, scale, window, k_offset)
    p = torch.exp(s - lse.reshape(b, 1, h, sq, 1))
    dog = do.reshape(b, 1, h, sq, d)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog.float(), v.float())
    ds = p * (dp - di.reshape(b, 1, h, sq, 1))
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p.to(do.dtype).float(),
                      dog.float())
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds.to(q.dtype).float(),
                      q.reshape(b, 1, h, sq, d).float())
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds.to(k.dtype).float(), k.float())
    if scale != 1.0:
        dk, dq = dk * scale, dq * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def takes_two_sweeps(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's backward dispatch: the two sweeps K3a/K3b when
    the fused backward's ``rep·Sq·D`` f32 dq accumulator would exceed
    ``_FUSED_BWD_DQ_BYTES``, else K2."""
    _, _, sq, d = q.shape
    return _gqa_rep(q, k) * sq * d * 4 > _FUSED_BWD_DQ_BYTES


def _check_flash(q: torch.Tensor, named) -> None:
    """Raise on what the flash kernels do not take: every tensor on q's
    CUDA device and contiguous; q/k/v/do of one dtype, f32 or bf16; the
    ``[B, H, Sq]`` rows lse and di f32; head grouping and D <= 128."""
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels need CUDA tensors, got {q.device}")
    for name, x in named.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        rows = name in ("lse", "di")
        want = torch.float32 if rows else q.dtype
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}, got {x.dtype}")
        if rows and x.shape != q.shape[:3]:
            raise ValueError(f"{name} must be [B, H, Sq] = "
                             f"{tuple(q.shape[:3])}, got {tuple(x.shape)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    k, v = named["k"], named["v"]
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]):
        raise ValueError(f"flash kernels take q [B, H, Sq, D] and k, v "
                         f"[B, Hkv, Sk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _gqa_rep(q, k)
    if q.shape[3] > 128:
        raise ValueError(f"flash kernels take D <= 128, got {q.shape[3]}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, scale: float, window: Optional[int] = None,
                  k_offset: int = 0, want_lse: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1, the flash forward — the port of the Pallas ``_flash_kernel``
    (``want_lse``) and ``_flash_kernel_nolse`` (``csrc/flash_fwd.cu``).
    Returns ``(o, lse [B, H, Sq] f32 or None)``.

    A CUDA ``q`` launches the kernel or raises (see :func:`_check_flash`);
    a CPU ``q`` gets the plain version, the only reason it ever runs. K1
    is also registered as the ops ``pddl_tpu_torch::flash_fwd`` and
    ``pddl_tpu_torch::flash_fwd_nolse``, whose fake versions give
    ``torch.export`` the outputs' shapes: a traced call (its tensors are
    not plain tensors, e.g. ``torch.export``'s fake ones) records the op,
    so an exported program on the card carries K1 (``ckpt/export.py``),
    while an eager call launches straight through ``ctypes``, without
    the op's dispatch (tens of µs a call, ``chip_smoke.py``'s
    ``k1_op_cost``)."""
    if q.device.type == "cpu":
        o, lse = flash_forward_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, k_offset=k_offset)
        return o, (lse if want_lse else None)
    args = (q, k, v, bool(causal), float(scale), int(window or 0),
            int(k_offset))
    if type(q) is torch.Tensor:
        return _flash_fwd_launch(*args, want_lse)
    _check_flash(q, {"k": k, "v": v})  # at trace time
    if want_lse:
        return torch.ops.pddl_tpu_torch.flash_fwd(*args)
    return torch.ops.pddl_tpu_torch.flash_fwd_nolse(*args), None


def _flash_fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, scale: float, window: int, k_offset: int,
                      want_lse: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's launch through ``ctypes`` after :func:`_check_flash`'s checks
    (``window`` 0 for none), counted in ``_kernels.launch_counts``: the
    eager call's and the registered ops' body."""
    _check_flash(q, {"k": k, "v": v})
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    lib = _kernels.library("flash_fwd")
    code = lib.pddl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, hkv, sq, sk, d,
        int(causal), window, k_offset, scale, _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check("flash_fwd", code)
    _kernels.launch_counts["flash_fwd" if want_lse else "flash_fwd_nolse"] += 1
    return o, lse


@torch.library.custom_op("pddl_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, window: int, k_offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _flash_fwd_launch(q, k, v, causal, scale, window, k_offset, True)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, window, k_offset):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("pddl_tpu_torch::flash_fwd_nolse", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_nolse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, window: int,
                        k_offset: int) -> torch.Tensor:
    return _flash_fwd_launch(q, k, v, causal, scale, window, k_offset,
                             False)[0]


@_flash_fwd_nolse_op.register_fake
def _flash_fwd_nolse_fake(q, k, v, causal, scale, window, k_offset):
    return torch.empty_like(q)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   dlse: Optional[torch.Tensor] = None, *, causal: bool,
                   scale: float, window: Optional[int] = None,
                   k_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward: ``(dq, dk, dv)`` for ``o = flash(q, k, v)``
    with saved ``lse`` and cotangents ``do`` (and ``dlse``, the LSE
    output's, or None).

    Dispatches as the JAX package does (:func:`takes_two_sweeps`): the
    fused K2 when its dq accumulator fits ``_FUSED_BWD_DQ_BYTES``, else
    the two sweeps K3a (:func:`flash_backward_dq`) and K3b
    (:func:`flash_backward_dkv`), all in ``csrc/flash_bwd.cu``. A CPU
    ``q`` gets the plain version on either branch. A CUDA ``q`` launches
    the branch's kernels or raises: nothing falls back quietly."""
    b, h, sq, d = q.shape
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, dlse, causal=causal,
                                    scale=scale, window=window,
                                    k_offset=k_offset)
    _check_flash(q, {"k": k, "v": v, "o": o, "do": do, "lse": lse})
    di = _row_term(o, do, dlse)
    kw = dict(causal=causal, scale=scale, window=window, k_offset=k_offset)
    if takes_two_sweeps(q, k):
        return (flash_backward_dq(q, k, v, do, lse, di, **kw),
                *flash_backward_dkv(q, k, v, do, lse, di, **kw))
    dq = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.library("flash_bwd")
    code = lib.pddl_flash_bwd(*_bwd_operands(q, k, v, do, lse, di),
                              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                              *_bwd_scalars(q, k, **kw))
    _kernels.check("flash_bwd", code)
    _kernels.launch_counts["flash_bwd_fused"] += 1
    return dq.to(q.dtype), dk, dv


def _bwd_operands(q, k, v, do, lse, di):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr())


def _bwd_scalars(q, k, *, causal, scale, window, k_offset):
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d, int(causal), window or 0,
            k_offset, scale, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_backward_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor, di: torch.Tensor,
                      *, causal: bool, scale: float,
                      window: Optional[int] = None, k_offset: int = 0
                      ) -> torch.Tensor:
    """K3a, the dq sweep of the two-sweep backward — the port of the
    Pallas ``_flash_bwd_dq_kernel``. ``di [B, H, Sq]`` f32 is the row term
    :func:`flash_backward` builds. Returns dq in q's dtype, written once
    with no atomics (bitwise reproducible). A CUDA ``q`` launches the
    kernel or raises; a CPU ``q`` gets the plain version's dq."""
    kw = dict(causal=causal, scale=scale, window=window, k_offset=k_offset)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, lse, do, di, **kw)[0]
    _check_flash(q, {"k": k, "v": v, "do": do, "lse": lse, "di": di})
    dq = torch.empty_like(q)
    code = _kernels.library("flash_bwd").pddl_flash_bwd_dq(
        *_bwd_operands(q, k, v, do, lse, di), dq.data_ptr(),
        *_bwd_scalars(q, k, **kw))
    _kernels.check("flash_bwd", code)
    _kernels.launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_backward_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       di: torch.Tensor, *, causal: bool, scale: float,
                       window: Optional[int] = None, k_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b, the dk/dv sweep of the two-sweep backward — the port of the
    Pallas ``_flash_bwd_dkv_kernel``: ``(dk, dv)`` in k's dtype, summed
    over each kv head's query group. A CUDA ``q`` launches the kernel or
    raises; a CPU ``q`` gets the plain version's dk, dv."""
    kw = dict(causal=causal, scale=scale, window=window, k_offset=k_offset)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, lse, do, di, **kw)[1:]
    _check_flash(q, {"k": k, "v": v, "do": do, "lse": lse, "di": di})
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = _kernels.library("flash_bwd").pddl_flash_bwd_dkv(
        *_bwd_operands(q, k, v, do, lse, di), dk.data_ptr(), dv.data_ptr(),
        *_bwd_scalars(q, k, **kw))
    _kernels.check("flash_bwd", code)
    _kernels.launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


def _forward_saving(ctx, q, k, v, causal, scale, window, k_offset):
    """K1 with the LSE, saving ``(q, k, v, o, lse)`` for the backward."""
    o, lse = flash_forward(q, k, v, causal=causal, scale=scale, window=window,
                           k_offset=k_offset)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.cfg = dict(causal=causal, scale=scale, window=window,
                   k_offset=k_offset)
    return o, lse


class _Flash(torch.autograd.Function):
    """``o = flash(q, k, v)``: the backward has no LSE cotangent to fold."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, k_offset):
        return _forward_saving(ctx, q, k, v, causal, scale, window,
                               k_offset)[0]

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, o, lse = ctx.saved_tensors
        if dlse is not None:
            dlse = dlse.contiguous()
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(), dlse,
                                    **ctx.cfg)
        return dq, dk, dv, None, None, None, None


class _FlashLse(_Flash):
    """``(o, lse) = flash(q, k, v)``: the backward folds the LSE cotangent
    into the row term, ``di = rowsum(do⊙o) − dlse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, k_offset):
        return _forward_saving(ctx, q, k, v, causal, scale, window, k_offset)


def _attention_reference_lse(q, k, v, causal, scale, window=None,
                             k_offset=0):
    """O(S²) ``(o, lse)`` in f32 with :func:`attention_reference`'s exact
    masking (the JAX package's fallback of ``flash_attention_lse`` for
    shapes its Pallas tiles do not divide); grouped K/V unexpanded."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[-3], k.shape[-2]
    rep = _gqa_rep(q, k)
    qg = q.reshape(b, hkv, rep, sq, d).float()
    s = scale * torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :] + k_offset
        mask = q_pos >= k_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype), lse.reshape(b, h, sq)


# ------------------------------------------------------ row-cache decoding
def cache_slot_insert(pool: torch.Tensor, row: torch.Tensor,
                      slot: int) -> torch.Tensor:
    """Copy a batch-1 cache leaf ``row [1, ...]`` into row ``slot`` of the
    pooled leaf ``pool [S, ...]`` (the serving engine's slot model: one
    resident cache whose batch dim is a pool of request slots). The whole
    row is overwritten, so nothing of the slot's previous occupant stays
    reachable. Writes ``pool`` in place (the JAX function returns a new
    array) and returns it."""
    if tuple(row.shape) != (1,) + tuple(pool.shape[1:]):
        raise ValueError(f"row {tuple(row.shape)} is not a batch-1 slice "
                         f"of pool {tuple(pool.shape)}")
    if not 0 <= int(slot) < pool.shape[0]:
        raise ValueError(f"slot {slot} outside [0, {pool.shape[0]})")
    pool[int(slot)] = row[0]
    return pool


def cache_slot_reset(pool: torch.Tensor, slot: int) -> torch.Tensor:
    """Zero one slot row of a pooled cache leaf, in place."""
    return cache_slot_insert(
        pool, torch.zeros((1,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                          device=pool.device), slot)


def _block_ids(block_ids, n: int, device) -> torch.Tensor:
    """Block ids as a long tensor on ``device``, checked on the host
    against the pool's ``n`` blocks (an id out of range would fault on the
    card, where the JAX function clamps it)."""
    ids = np.asarray(torch.as_tensor(block_ids).cpu(), dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError(f"block_ids must be [M], got {ids.shape}")
    if ids.size and not (0 <= ids.min() and ids.max() < n):
        raise ValueError(f"block ids {ids.tolist()} outside [0, {n})")
    return torch.from_numpy(ids).to(device)


def cache_blocks_gather(pool: torch.Tensor, block_ids) -> torch.Tensor:
    """Gather KV blocks ``block_ids [M]`` of a block-pool leaf
    ``[N, ..., block_size, D]`` into one contiguous batch-1 prefix
    ``[1, ..., M*block_size, D]`` (block ``j``'s tokens land at positions
    ``[j*block_size, (j+1)*block_size)``). A copy: a slot filled from it
    never aliases pool storage."""
    if pool.ndim < 3:
        raise ValueError(f"pool leaf must be [N, ..., block_size, D], got "
                         f"{tuple(pool.shape)}")
    ids = _block_ids(block_ids, pool.shape[0], pool.device)
    m = ids.numel()
    bs, d = pool.shape[-2], pool.shape[-1]
    g = pool[ids].movedim(0, -3)                # [..., M, bs, D]
    return g.reshape(g.shape[:-3] + (m * bs, d))[None]


def cache_blocks_scatter(pool: torch.Tensor, row: torch.Tensor, block_ids,
                         start_block: int) -> torch.Tensor:
    """Write a batch-1 cache row's tokens ``[start_block*block_size,
    (start_block+M)*block_size)`` into pool blocks ``block_ids [M]`` of a
    ``[N, ..., block_size, D]`` leaf (the donation half of the prefix
    cache). Source positions past the row's end are clamped per token, as
    in the JAX function (a padded tail block reads junk, never a shifted
    slice). Writes ``pool`` in place and returns it."""
    if row.shape[0] != 1 or row.ndim != pool.ndim:
        raise ValueError(f"row {tuple(row.shape)} is not a batch-1 cache "
                         f"leaf matching pool {tuple(pool.shape)}")
    ids = _block_ids(block_ids, pool.shape[0], pool.device)
    m = ids.numel()
    bs, d = pool.shape[-2], pool.shape[-1]
    pos = int(start_block) * bs + torch.arange(m * bs, device=pool.device)
    window = row[0].index_select(-2, pos.clamp(max=row.shape[-2] - 1))
    blocks = window.reshape(window.shape[:-2] + (m, bs, d)).movedim(-3, 0)
    pool[ids] = blocks.to(pool.dtype)
    return pool


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: IndexLike, *,
                     window: Optional[int] = None, rolling: bool = False,
                     chunk: int = 512, scale: Optional[float] = None,
                     history_only: bool = False, return_lse: bool = False,
                     max_index: Optional[int] = None):
    """Attention over a row KV cache (the port of the JAX package's
    ``decode_attention``; plain PyTorch on every device, as the JAX
    package leaves it to XLA).

    Args:
      q: ``[B, H, S, D]`` post-RoPE queries (``S`` tokens being decoded).
      k_cache/v_cache: ``[B, H_kv, L, D]``, the current tokens already
        written at their slots (unless ``history_only``), read in their
        storage dtype and never expanded to ``H``.
      index: tokens in the cache BEFORE this call (queries sit at global
        positions ``index .. index+S-1``): an int, a 0-d tensor, or a
        per-row ``[B]`` tensor (the serving engine's slots, each at its
        own depth).
      window: sliding-window width; keys below ``q_pos - window + 1`` are
        masked.
      rolling: the cache is a RING of ``L >= window`` slots: slot ``j``
        holds the newest position ``p ≡ j (mod L)`` with
        ``p <= index+S-1``; never-written slots (``p < 0``) are masked.
      chunk: keys per step of the online softmax for multi-token blocks
        (it bounds the f32 score memory); a single-token step scores the
        whole live prefix in one pass. Tuning, not semantics.
      history_only: the cache holds only the ``index`` tokens BEFORE this
        block, which is not written: queries attend to ``pos < index``
        (the chunked-prefill building block, merged with the block's own
        attention in logsumexp space). A row that sees no key (no
        history, or none inside its window) returns 0 and lse
        ``≈ NEG_INF``, so a merge gives it zero weight (the JAX function
        returns junk ``o`` for the second kind, with the same lse).
      return_lse: also return the per-row logsumexp ``[B, H, S]`` f32.
      max_index: the deepest row's ``index`` as a host int, when ``index``
        is a tensor: the sweep then reads only the live prefix
        ``[0, max_index + S)`` (``max_index`` under ``history_only``).
        Without it a tensor index sweeps the whole cache (same result,
        more bytes, and no host sync). An int ``index`` is its own bound.

    Scores are f32 over q cast to the cache's dtype; p is rounded to v's
    dtype before the P·V product, both as in the JAX function. Returns
    ``[B, H, S, D]`` in q's dtype (and the lse under ``return_lse``).
    """
    b, h, s, d = q.shape
    hkv, cache_len = k_cache.shape[1], k_cache.shape[2]
    rep = _gqa_rep(q, k_cache)
    if isinstance(index, torch.Tensor) and index.ndim:
        if index.ndim > 1 or index.shape[0] != b:
            raise ValueError(f"index must be a scalar or [B]={b} vector, "
                             f"got {tuple(index.shape)}")
        idx = index.to(device=q.device, dtype=torch.long)[:, None]  # [B, 1]
        q_pos = idx + torch.arange(s, device=q.device)             # [B, s]
        before = idx[:, :, None]                                   # [B, 1, 1]
    else:
        # A shared position stays a host int: no copy to the device.
        idx = before = max_index = host_index(index)
        q_pos = torch.arange(idx, idx + s, device=q.device)        # [s]
    if rolling:
        if window is None:
            raise ValueError("rolling=True needs a sliding window (the ring "
                             "holds only the newest position per slot — "
                             "unwindowed attention would silently miss "
                             "overwritten history)")
        if cache_len < window:
            raise ValueError(
                f"rolling cache length {cache_len} < window {window}: "
                "in-window keys would be overwritten before leaving the "
                "band")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    total = idx if history_only else idx + s
    # The live prefix: slots [0, live) hold every token any row has (a
    # ring is dense once it wrapped).
    live = cache_len
    if max_index is not None:
        # Compared, not min()'d: a traced step's symbolic bound then stays
        # a plain sum its trace can prove in range.
        live = max_index + (0 if history_only else s)
        live = cache_len if live > cache_len else (0 if live < 0 else live)
    qg = q.reshape(b, hkv, rep, s, d).to(k_cache.dtype).float()
    m = l = acc = None  # the online softmax's state, from the first chunk
    if isinstance(live, torch.SymInt) and s == 1:
        spans = [(0, live)]  # a traced step: one pass, its length symbolic
    else:
        step = live if s == 1 else min(chunk, cache_len)
        spans = [(start, min(start + step, live))
                 for start in range(0, live, max(step, 1))]
    for start, stop in spans:
        kc = k_cache.narrow(2, start, stop - start).float()
        sb = torch.einsum("bgrqd,bgkd->bgrqk", qg, kc) * scale_v
        slot = torch.arange(start, stop, device=q.device)
        if rolling:
            t1 = total - 1
            pos = t1 - torch.remainder(t1 - slot, cache_len)  # [n]|[B, n]
        else:
            pos = slot
        if history_only:
            mask = pos[..., None, :] < before
        else:
            mask = pos[..., None, :] <= q_pos[..., :, None]
        if window is not None:
            mask = mask & (pos[..., None, :] > q_pos[..., :, None] - window)
        if rolling:
            mask = mask & (pos >= 0)[..., None, :]
        sb = torch.where(mask if mask.ndim == 2 else mask[:, None, None],
                         sb, NEG_INF)
        m_new = sb.amax(dim=-1, keepdim=True)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = torch.exp(sb - m_new)
        pv = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v_cache.dtype).float(),
                          v_cache.narrow(2, start, stop - start).float())
        if m is None:
            l, acc = p.sum(dim=-1, keepdim=True), pv
        else:
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pv
        m = m_new
    if m is None:  # nothing live: the empty sweep
        f32 = dict(dtype=torch.float32, device=q.device)
        m = torch.full((b, hkv, rep, s, 1), NEG_INF, **f32)
        l = torch.zeros((b, hkv, rep, s, 1), **f32)
        acc = torch.zeros((b, hkv, rep, s, d), **f32)
    if history_only:
        # A row that saw no key (no history, or none inside its window)
        # keeps the empty sweep's state: its fully masked chunks would
        # otherwise average junk with weight 1. Only history_only can
        # leave a row empty: otherwise each query sees its own token.
        seen = m > NEG_INF
        l = torch.where(seen, l, 0.0)
        acc = torch.where(seen, acc, 0.0)
    l = l.clamp_min(1e-30)
    out = (acc / l).reshape(b, h, s, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(b, h, s)
    return out


def _check_table(block_table: torch.Tensor, b: int) -> None:
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(
            f"block_table must be [B={b}, T], got {tuple(block_table.shape)}")


def paged_cache_insert(pool: torch.Tensor, kv: torch.Tensor,
                       block_table: torch.Tensor,
                       index: IndexLike) -> torch.Tensor:
    """Write ``kv [B, H_kv, s, D]`` at global positions
    ``index (+ arange(s))`` into pool blocks resolved through
    ``block_table [B, T]`` (``pool [N, H_kv, block_size, D]``).

    Unlike the JAX function, which returns a new array, this writes the
    pool IN PLACE (``index_put_``) and returns it — the pool is the
    serving engine's one KV store and is never copied.

    ``index`` is an int (batch-1 chunk prefill) or a per-row ``[B]``
    tensor (the serving tick: every row writes one token at its own
    depth). Positions whose block index falls outside the table are
    deflected to the scratch block, so padded prefill junk beyond a
    prompt's allocated blocks can never reach a real block.

    The multi-token batch-1 path works at block granularity: read the
    span's blocks, splice the chunk in contiguously, write whole blocks
    back.
    """
    n, hkv, bs, d = pool.shape
    b, _, s, _ = kv.shape
    _check_table(block_table, b)
    t = block_table.shape[1]
    kv = kv.to(pool.dtype)
    if s > 1 and b == 1:
        start = int(index)
        first = start // bs
        n_span = -(-s // bs) + 1
        span = first + torch.arange(n_span, device=pool.device)
        ids = torch.where(span < t,
                          block_table[0, span.clamp(max=t - 1)].long(), 0)
        flat = pool[ids].transpose(0, 1).reshape(hkv, n_span * bs, d)
        off = start % bs
        flat[:, off:off + s] = kv[0]
        pool[ids] = flat.reshape(hkv, n_span, bs, d).transpose(0, 1)
        return pool
    index = torch.as_tensor(index, dtype=torch.long, device=pool.device)
    pos = index[..., None] + torch.arange(s, device=pool.device)
    pos = pos.expand(b, s)
    blk = pos // bs
    off = pos % bs
    bid = torch.gather(block_table.long(), 1, blk.clamp(max=t - 1))
    bid = torch.where(blk < t, bid, 0)
    updates = kv.transpose(1, 2).reshape(b * s, hkv, d)
    pool[bid.reshape(-1), :, off.reshape(-1)] = updates
    return pool


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           index: IndexLike, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           blocks_per_chunk: Optional[int] = None,
                           kernel: Optional[bool] = None,
                           interpret: Optional[bool] = None,
                           max_index: Optional[int] = None) -> torch.Tensor:
    """Attention over a paged KV pool through a per-row block table.

    Semantically decode attention over the VIRTUAL cache
    ``cache[b, :, j*bs + o] == pool[block_table[b, j], :, o]``: query
    ``i`` of row ``b`` (global position ``index[b] + i``) attends every
    cached position at or before its own (and inside ``window``).

    Args:
      q: ``[B, H, s, D]`` post-RoPE queries (``s == 1`` on the decode
        tick; ``s > 1`` for a chunked prefill continuing at ``index``).
      k_pool/v_pool: ``[N, H_kv, block_size, D]``; the current tokens
        must already be written (:func:`paged_cache_insert` runs first).
      block_table: ``[B, T]`` int32 pool block ids.
      index: tokens in the (virtual) cache before this call; an int or a
        per-row ``[B]`` tensor.
      window: sliding-window mask.
      blocks_per_chunk: accepted for the JAX signature and ignored (a
        tuning knob of the JAX plain path's chunked sweep); the kernel
        chooses its own split of the table. So is ``interpret``, the
        Pallas interpret-mode switch.
      kernel: ``None`` (default) sends single-token steps to
        :func:`paged_decode_attention_kernel` — the CUDA kernel for CUDA
        tensors, its plain version for CPU tensors — and multi-token
        chunks to the plain path; ``False`` forces the plain path;
        ``True`` forces the kernel wrapper (``s == 1`` only).
      max_index: the deepest row's ``index`` as a host int (a port-only
        argument, as in :func:`decode_attention`): the plain path then
        gathers the live blocks with no host sync. An int ``index`` is
        its own bound; without either, one sync reads the bound.

    Returns ``[B, H, s, D]`` in q's dtype.
    """
    b, h, s, d = q.shape
    _gqa_rep(q, k_pool)
    _check_table(block_table, b)
    if isinstance(index, int):
        max_index = index
    index = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    if index.ndim > 1 or (index.ndim == 1 and index.shape[0] != b):
        raise ValueError(
            f"index must be a scalar or [B]={b} vector, "
            f"got {tuple(index.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    if kernel is None:
        kernel = s == 1
    if kernel:
        if s != 1:
            raise ValueError(
                "the paged decode kernel serves single-token decode steps "
                f"only (got a {s}-token block); multi-token prefill takes "
                "the plain path (kernel=False)")
        return paged_decode_attention_kernel(
            q, k_pool, v_pool, block_table, index, scale=scale_v,
            window=window)
    return _paged_attention_plain(q, k_pool, v_pool, block_table, index,
                                  scale_v, window, max_index)


def _paged_attention_plain(q, k_pool, v_pool, block_table, index, scale,
                           window, max_index=None):
    """The plain PyTorch version: gather each row's live blocks into a
    dense ``[B, H_kv, L, D]`` view (``L`` covers the deepest row's
    prefix, ``max_index + s`` when the caller knows it on the host, so
    traffic is bounded by the live prefix), then one masked softmax in
    f32. Rounding points follow the kernel: q is cast to the pool's
    type, p to v's type before the P·V product."""
    b, h, s, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    t = block_table.shape[1]
    rep = h // hkv
    index = index.to(torch.long)
    q_pos = index.reshape(-1, 1) + torch.arange(s, device=q.device)  # [B|1, s]
    q_pos = q_pos.expand(b, s)
    deepest = int(q_pos.max()) if max_index is None else max_index + s - 1
    n_live = min(t, deepest // bs + 1)
    ids = block_table[:, :n_live].long()                         # [B, n]
    kc = k_pool[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_live * bs, d)
    vc = v_pool[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_live * bs, d)
    qg = q.reshape(b, hkv, rep, s, d).to(k_pool.dtype).float()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kc.float()) * scale
    pos = torch.arange(n_live * bs, device=q.device)
    mask = pos[None, None, :] <= q_pos[:, :, None]                # [B, s, L]
    if window is not None:
        mask &= pos[None, None, :] > q_pos[:, :, None] - window
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v_pool.dtype).float(),
                       vc.float())
    return (acc / l.clamp_min(1e-30)).reshape(b, h, s, d).to(q.dtype)


# The paged decode kernel's split of the table (``paged_split_plan``): at
# most 8 entries and 128 tokens per split, about 2 blocks per SM.
_SPLIT_ENTRIES = 8
_SPLIT_TOKENS = 128
_SPLIT_BLOCKS_PER_SM = 2


def paged_split_plan(b: int, hkv: int, t: int, bs: int,
                     sm_count: int) -> Tuple[int, int]:
    """``(n_split, per_split)``: the paged decode kernel splits each row's
    ``t`` table entries into ``n_split`` contiguous ranges of
    ``per_split`` entries (the last may be shorter), one block each per
    (row, kv head).

    It depends on the shapes and the card's SM count alone, never on the
    rows' depths, so the launch geometry is the same on every decode tick.
    Where one block per (row, kv head) already fills the card there is one
    split. Otherwise the ranges shrink toward ``_SPLIT_BLOCKS_PER_SM``
    blocks per SM, down to one entry, and never exceed ``_SPLIT_ENTRIES``
    entries or ``_SPLIT_TOKENS`` tokens: that bounds each block's chain of
    dependent loads."""
    groups = b * hkv
    if groups >= sm_count:
        return 1, t
    cap = max(1, min(_SPLIT_ENTRIES, _SPLIT_TOKENS // bs))
    fill = -(-t * groups // (_SPLIT_BLOCKS_PER_SM * sm_count))
    per = min(cap, max(1, fill))
    return -(-t // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def paged_decode_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_table: torch.Tensor,
                                  index: IndexLike, *,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  interpret: Optional[bool] = None
                                  ) -> torch.Tensor:
    """The paged decode kernel (single-token steps) — the port of the
    Pallas ``_paged_decode_kernel`` (``csrc/paged_decode.cu``);
    ``interpret``, the Pallas interpret-mode switch, is accepted for the
    JAX signature and ignored.

    A CUDA ``q`` launches the kernel or raises: the wrapper checks
    device, dtype, shape and contiguity, chooses the split of the table
    (:func:`paged_split_plan`), allocates the output and the splits'
    f32 scratch, launches on the current stream (the split kernel, then
    the merge where there is more than one split: one count) and raises
    on the C entry's nonzero return.
    A CPU ``q`` gets the plain version (:func:`paged_decode_attention`'s
    torch path) — the only reason it ever runs instead of the kernel.
    """
    b, h, s, d = q.shape
    if s != 1:
        raise ValueError(f"decode kernel takes single-token steps, got s={s}")
    n, hkv, bs, _ = k_pool.shape
    _gqa_rep(q, k_pool)
    t = block_table.shape[1]
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    index = torch.as_tensor(index, dtype=torch.int32, device=q.device)
    index = index.expand(b).contiguous()
    if q.device.type == "cpu":
        return _paged_attention_plain(q, k_pool, v_pool, block_table, index,
                                      scale_v, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode kernel needs a CUDA tensor, got "
                         f"{q.device}")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_table": block_table, "index": index}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"paged decode kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"q, k_pool and v_pool must share a dtype, got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if v_pool.shape != k_pool.shape or k_pool.shape[-1] != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    _check_table(block_table, b)
    if block_table.dtype != torch.int32:
        raise ValueError(f"block_table must be int32, got {block_table.dtype}")
    if d > 256 or bs > 64:
        raise ValueError(f"paged decode kernel takes D <= 256 and "
                         f"block_size <= 64, got D={d}, block_size={bs}")
    lib = _kernels.library("paged_decode")
    n_split, per_split = paged_split_plan(b, hkv, t, bs,
                                          _sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    scratch = (torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    code = lib.pddl_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), index.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        b, h, hkv, n, bs, d, t, window or 0, scale_v, n_split, per_split,
        _KERNEL_DTYPES[q.dtype], stream)
    _kernels.check("paged_decode", code)
    _kernels.launch_counts["paged_decode"] += 1
    return out
