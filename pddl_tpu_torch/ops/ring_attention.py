"""Ring attention: sequence parallelism over the ``seq`` axis of the mesh
(the port of :mod:`pddl_tpu.ops.ring_attention`).

The sequence is cut over the processes of a group, one contiguous shard
each, in the group's order. Each process keeps its query shard and the
key/value shards rotate around the ring (:func:`~pddl_tpu_torch.core.
collectives.shift_counted`, one hop a rotation, K and V packed into one
message), so every query meets every key without any process holding the
whole sequence. A process group replaces JAX's ``axis_name`` (``None``:
the default group; with no group initialized a ring of one, plain local
attention), and :func:`sequence_parallel_attention` takes the port's
:class:`~pddl_tpu_torch.core.mesh.Mesh` where JAX takes its mesh. The
inputs are this process's shards ``[B, H, S/n, D]`` (K/V at their own,
unexpanded, head count) and the result is its shard of the output: JAX's
shard_map holds the global arrays, here each process holds its part.

Causal masking uses global positions: query ``my·s + t`` against the
visiting shard's keys ``src·s + j``. Rotation ``i`` brings the shard of
``src = (my − i) mod n``; under ``causal`` the diagonal (rotation 0) is
masked row by row, earlier shards not at all, and later ones (which
wrap around the ring) have weight exactly 0: the port skips their
compute where JAX computes and masks it (grid and wasted work are not
contracts), while their keys still travel on. With a sliding ``window``
only the :func:`_band_hops` rotations that can hold in-band keys run,
each with ``k_offset = −i·s``, and the rotations beyond them make no hop.

Each call is one ``torch.autograd.Function`` whose backward runs its own
exchanges in a fixed order, the same on every rank: the visiting shards
are kept from the forward, each rotation's ``dk, dv`` is computed where
its queries are, and it is sent straight back to the shard's owner
(a shift by ``−i``; zeros for a skipped rotation, so every send has its
receive). The shifts are counted in
:data:`~pddl_tpu_torch.core.collectives.TP_COUNTS` as ``ring_kv_fwd``
(one a hop, K and V together) and ``ring_dkv_bwd``.

- :func:`ring_attention` is the plain path: the einsum online softmax in
  f32 over each rotation's scores, its backward the block gradients
  under the final logsumexp; it launches no kernel.
- :func:`ring_attention_flash` runs each rotation through K1 with its LSE
  (:func:`~pddl_tpu_torch.ops.attention.flash_forward`; the plain version
  on the CPU) and merges the normalized partials in logsumexp space,
  ``o = Σ oᵢ·exp(lseᵢ − LSE)``. Its backward runs each rotation's
  :func:`~pddl_tpu_torch.ops.attention.flash_backward` (K2, or K3a/K3b by
  ``takes_two_sweeps``) with that rotation's cotangents
  ``doᵢ = wᵢ·do`` and ``dlseᵢ = wᵢ·rowsum(do⊙(oᵢ − o))``, ``wᵢ =
  exp(lseᵢ − LSE)``: the chain rule through the merge, as JAX's autodiff
  of the same merge gives.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from pddl_tpu_torch.core.collectives import (
    axis_index,
    axis_size,
    shift_counted,
)
from pddl_tpu_torch.ops.attention import (
    NEG_INF,
    _backward_plain,
    _flash_scores,
    _fold_scale,
    _gqa_rep,
    _normalize_window,
    flash_backward,
    flash_forward,
)


def _band_hops(n: int, s_local: int, window: Optional[int]) -> int:
    """Ring rotations that can carry in-band keys (incl. the diagonal).

    The sliding-window band is translation-invariant along the ring, so
    rotation ``i`` contributes iff the shard ``i`` hops back overlaps
    some query's ``(q-window, q]`` — a STATIC property of ``i``:
    ``i·s_local <= window + s_local - 2``. Rotations (and their hops)
    beyond that are skipped entirely: compute and traffic scale
    O(window), not O(S)."""
    if window is None:
        return n
    return min(n, (window + s_local - 2) // s_local + 1)


def _rotation(i: int, my: int, n: int, s_local: int, causal: bool,
              window: Optional[int]):
    """Rotation ``i``'s mask as ``(causal, window, k_offset)``, or None
    when its shard has weight 0 (a later shard under ``causal``)."""
    if not causal:
        return False, None, 0
    if i == 0:
        return True, window, 0
    if (my - i) % n > my:
        return None
    if window is None:
        return False, None, 0
    return True, window, -i * s_local


class _Ring(torch.autograd.Function):
    """One ring-attention call (module docstring). ``flash`` picks the
    per-rotation compute: K1/K2 (:func:`ring_attention_flash`) or the
    plain online softmax (:func:`ring_attention`)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, window, flash):
        group, n, my = ring
        s_local = q.shape[2]
        hops = _band_hops(n, s_local, window)
        kv = torch.stack([k, v])
        visits: List[Tuple[int, tuple]] = []
        saved: List[torch.Tensor] = []
        fwd = _flash_rotations if flash else _plain_rotations
        state = None
        for i in range(hops):
            if i:
                kv = shift_counted(kv, group, 1, "ring_kv_fwd")
            rot = _rotation(i, my, n, s_local, causal, window)
            if rot is None:
                continue
            state, extra = fwd(state, q, kv[0], kv[1], rot, scale)
            visits.append((i, rot))
            saved += [kv[0], kv[1], *extra]
        o, lse = (_flash_finish if flash else _plain_finish)(state, q)
        ctx.save_for_backward(q, o, lse, *saved)
        ctx.cfg = (group, scale, flash, hops, visits)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        group, scale, flash, hops, visits = ctx.cfg
        q, o, lse, *saved = ctx.saved_tensors
        do = do.contiguous()
        per = 4 if flash else 2
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = {}
        di = None if flash else (do.float() * o.float()).sum(dim=-1)
        for j, (i, (causal_i, window_i, k_off)) in enumerate(visits):
            kc, vc, *extra = saved[j * per:(j + 1) * per]
            kw = dict(causal=causal_i, scale=scale, window=window_i,
                      k_offset=k_off)
            if flash:
                o_i, lse_i = extra
                w = torch.exp(lse_i - lse)
                do_i = (do.float() * w[..., None]).to(q.dtype)
                dlse_i = w * (do.float() * (o_i.float() - o)).sum(dim=-1)
                dq_i, dk_i, dv_i = flash_backward(
                    q, kc, vc, o_i, lse_i, do_i.contiguous(),
                    dlse_i.contiguous(), **kw)
            else:
                dq_i, dk_i, dv_i = _backward_plain(q, kc, vc, lse, do, di,
                                                   **kw)
            dq += dq_i.float()
            dkv[i] = torch.stack([dk_i, dv_i]).float()
        own = dkv[0]
        for i in range(1, hops):
            part = dkv.get(i)
            if part is None:
                part = torch.zeros_like(own)
            own = own + shift_counted(part, group, -i, "ring_dkv_bwd")
        dk, dv = own.to(q.dtype)
        return dq.to(q.dtype), dk, dv, None, None, None, None, None


def _plain_rotations(state, q, kc, vc, rot, scale):
    """One rotation of the online softmax: running max ``m``, denominator
    ``l`` and accumulator, f32, grouped ``[B, H_kv, rep, s, ·]``."""
    causal_i, window_i, k_off = rot
    s = _flash_scores(q, kc, causal_i, scale, window_i, k_off)
    if state is None:
        m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=s.device)
        state = (m, torch.zeros_like(m),
                 torch.zeros(s.shape[:-1] + (q.shape[-1],),
                             device=s.device))
    m, l, acc = state
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bgrqk,bgkd->bgrqd", p, vc.float())
    return (m_new, l, acc), ()


def _plain_finish(state, q):
    m, l, acc = state
    b, h, s, d = q.shape
    l = l.clamp_min(1e-30)
    o = (acc / l).reshape(b, h, s, d)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return o, lse


def _flash_rotations(state, q, kc, vc, rot, scale):
    """One rotation through K1 with its LSE, merged in logsumexp space."""
    causal_i, window_i, k_off = rot
    o_i, lse_i = flash_forward(q, kc, vc, causal=causal_i, scale=scale,
                               window=window_i, k_offset=k_off)
    if state is None:
        return (lse_i, torch.ones_like(lse_i), o_i.float()), (o_i, lse_i)
    m, s, acc = state
    m_new = torch.maximum(m, lse_i)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_i - m_new)
    s = s * alpha + w
    acc = acc * alpha[..., None] + o_i.float() * w[..., None]
    return (m_new, s, acc), (o_i, lse_i)


def _flash_finish(state, q):
    m, s, acc = state
    s = s.clamp_min(1e-30)
    return acc / s[..., None], m + torch.log(s)


def _ring(q, k, v, ring, causal, scale, window, flash):
    """``ring`` is ``(group, n, my)``: the group, its size and this
    process's position (a ring of one needs no group)."""
    d = q.shape[-1]
    _gqa_rep(q, k)
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    scale_v = (1.0 / math.sqrt(d)) if scale is None else scale
    if flash:
        q, scale_v = _fold_scale(q, scale_v)
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), ring,
                       causal, scale_v, window, flash)


def _ring_of(group):
    return group, axis_size(group), axis_index(group)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, *, causal: bool = False,
                   scale: Optional[float] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Per-shard ring attention over ``group`` (the plain path).

    Args are this process's shards ``[B, H, s, D]`` and ``[B, H_kv, s,
    D]`` (GQA: the unexpanded K/V shards travel, ``H/H_kv`` times fewer
    bytes a hop than expanded ones); returns this process's shard of the
    exact global attention in q's dtype. ``window`` (requires ``causal``):
    sliding-window attention, only :func:`_band_hops` rotations run."""
    return _ring(q, k, v, _ring_of(group), causal, scale, window,
                 flash=False)


def ring_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, *, causal: bool = False,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Ring attention whose per-rotation compute is the flash kernels:
    K1 with its LSE forward, K2 (or K3a/K3b) with the LSE cotangent
    backward, on the card; their plain versions on the CPU (module
    docstring). Same arguments as :func:`ring_attention`."""
    return _ring(q, k, v, _ring_of(group), causal, scale, window,
                 flash=True)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mesh, *,
                                axis_name: str = "seq", causal: bool = False,
                                scale: Optional[float] = None,
                                use_flash: bool = False,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Ring attention over ``mesh``'s ``axis_name`` axis: ``q, k, v`` are
    this process's shards of the global ``[B, H, S, D]`` arrays along S
    (``S = n·s``), the result its shard of the output. ``use_flash`` runs
    each rotation through the flash kernels (:func:`ring_attention_flash`)
    instead of the plain path. ``window`` (requires ``causal``) is
    normalized against the GLOBAL length, as the JAX function does: a
    window of at least ``S`` is plain causal attention."""
    _gqa_rep(q, k)
    n = mesh.shape[axis_name]
    window = _normalize_window(window, causal, n * k.shape[-2])
    ring = (mesh.axis_group(axis_name), n, mesh.axis_index(axis_name))
    return _ring(q, k, v, ring, causal, scale, window, flash=use_flash)
