"""Mixture-of-Experts: the top-k routed FFN (Switch top-1, GShard and
Mixtral top-2), ready for expert parallelism (the port of
:mod:`pddl_tpu.ops.moe`).

The routing is the JAX module's, step for step: a router ``Dense`` in
f32 and its softmax, then ``top_k`` sequential choices, each taking the
first maximum of what remains (``argmax`` takes the first maximum, as
``jnp.argmax`` does), queueing its tokens behind the tokens KEPT by the
earlier choices (the mesh-tf top-2 convention), and dropping those past
the capacity ``max(1, int(capacity_factor·top_k·S/N))`` of each batch
row (``S`` at eval with ``eval_dropless``). ``normalize_gates``
renormalizes the kept choices' gates by their sum (``+ 1e-9``); the
Switch aux loss ``aux_loss_weight·N·Σ fᵢ·Pᵢ`` counts first choices
before the drop; ``moe_drop_rate`` is the share of routed token slots
that found their expert's queue full.

Where the JAX module builds the dense ``[B, S, N, C]`` dispatch and
combine one-hots and contracts them in two einsums, the port gathers by
index: each kept token's row is copied into its expert's slot
``(b, n, c)`` (``index_add`` into zeros, a copy, since every slot takes
at most one token) and each token reads its slots back weighted by its
gates. The kept set, the positions and the gates are the einsums'; the
dense one-hot would be ``[B, S, 8, S]`` at eval-dropless on a
2,048-token row. The experts' products are batched ``einsum`` s over the
``[B, N, C, d]`` slots, as in the JAX module (its products run outside any
Pallas kernel too).

**Expert parallelism.** With an ``expert_group`` bound (by
:class:`~pddl_tpu_torch.parallel.ExpertParallelStrategy`), the module
holds the experts ``expert_offset .. expert_offset + n_local - 1`` of the
expert-major weights. Every position along the ``expert`` axis sees the
same rows (the batch is split over ``data`` only), so the router runs
replicated, each position runs its experts on the tokens dispatched to
them, and the partial outputs are summed over the group
(:func:`~pddl_tpu_torch.core.collectives.reduce_from_group`). The
backward sums each position's part of the input's gradient and of the
gates' (:func:`~pddl_tpu_torch.core.collectives.copy_to_group` on both),
while the aux loss, which every position computes whole, flows back once.

**Under a sequence-sharded mesh.** With a ``seq`` shard passed to the
forward (a model built on a mesh whose ``seq`` axis is above 1), each
process holds ``S/n`` tokens of every row, and the routing is still the
JAX module's over the whole row: the capacity is the global
``max(1, int(capacity_factor·top_k·S/N))``, and each choice's queue
positions continue from the earlier shards' tokens of that choice for
each (row, expert) — an exclusive prefix of the per-shard counts over
the ``seq`` group, one all-gather of ``[B, N]`` counts a choice — after
the tokens every shard kept in the earlier choices. So the capacity
drops fall on the tokens the JAX module drops. The aux loss and the drop
rate are the whole row's (the mean router probability summed over the
group by :func:`~pddl_tpu_torch.core.collectives.seq_sum`, whose
gradient the batch's average brings back to the one-process gradient).
A cached forward holds the whole sequence in every process and routes
it locally.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pddl_tpu_torch.core.collectives import (
    all_gather,
    copy_to_group,
    psum,
    reduce_from_group,
    seq_sum,
)


class Routing(NamedTuple):
    """One forward's routing: per choice ``j`` the chosen expert
    ``expert[j]`` ``[B, S]``, whether it was kept ``kept[j]``, its
    0-based queue position ``position[j]`` (0 where dropped) and its
    gate ``gates[j]`` (normalized when asked); ``probs`` ``[B, S, N]``,
    the capacity, the kept tokens per (row, expert) ``offset`` ``[B, N]``,
    and the first choices' one-hot ``first`` ``[B, S, N]``."""

    expert: List[torch.Tensor]
    kept: List[torch.Tensor]
    position: List[torch.Tensor]
    gates: List[torch.Tensor]
    probs: torch.Tensor
    capacity: int
    offset: torch.Tensor
    first: torch.Tensor


def capacity_of(s: int, num_experts: int, top_k: int,
                capacity_factor: float, dropless: bool) -> int:
    """Slots per expert per batch row: ``S`` when dropless, else
    ``max(1, int(capacity_factor·top_k·S/N))`` (the JAX expression)."""
    if dropless:
        return s
    return max(1, int(capacity_factor * top_k * s / num_experts))


def _sharded(seq) -> bool:
    return seq is not None and seq.n > 1


def route(probs: torch.Tensor, top_k: int, capacity: int,
          normalize_gates: bool = True,
          gate_probs: Optional[torch.Tensor] = None, seq=None) -> Routing:
    """The JAX module's ``top_k`` sequential choices over ``probs``
    ``[B, S, N]``. ``gate_probs`` (the same values, another autograd
    path: the expert-parallel gates) feeds the gates when given. ``seq``
    (a shard of ``n`` above 1: ``n``, this shard's index ``my`` and the
    ``group``) makes ``probs`` this shard's tokens of each row: positions
    continue from the earlier shards' tokens of the same choice, and
    ``offset`` counts the kept tokens of the whole row."""
    b, s, n = probs.shape
    remaining = probs if gate_probs is None else gate_probs
    offset = probs.new_zeros((b, n))
    experts, kept, positions, gates = [], [], [], []
    first = None
    for _ in range(top_k):
        # argmax returns the first maximum's index, as jnp.argmax does.
        idx = remaining.detach().argmax(dim=-1)
        gate = remaining.gather(-1, idx[..., None])[..., 0]
        raw = F.one_hot(idx, n).to(probs.dtype)               # [B, S, N]
        if first is None:
            first = raw
        remaining = remaining * (1.0 - raw)
        # This choice's tokens per (row, expert): on this shard, before it
        # (the earlier shards' queue ahead of this one's) and in the row.
        mine = raw.sum(dim=1)
        before, total = 0.0, mine
        if _sharded(seq):
            every = all_gather(mine, seq.group)               # [n, B, N]
            before, total = every[:seq.my].sum(dim=0), every.sum(dim=0)
        position = (torch.cumsum(raw, dim=1)
                    + (offset + before)[:, None, :]) * raw
        onehot = raw * (position <= capacity)
        # The row's queue for this choice holds offset+1 .. offset+total:
        # the kept ones are those up to the capacity.
        offset = offset + torch.minimum(total,
                                        (capacity - offset).clamp(min=0.0))
        keep = onehot.sum(dim=-1) > 0                         # [B, S]
        pos = ((position - 1.0) * onehot).sum(dim=-1).long()  # 0-based
        experts.append(idx)
        kept.append(keep)
        positions.append(pos)
        gates.append(gate)
    if top_k > 1 and normalize_gates:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    return Routing(experts, kept, positions, gates, probs, capacity, offset,
                   first)


def _he_normal_(t: torch.Tensor, fan_in: int, gen) -> None:
    """flax's ``he_normal``: a truncated normal (±2σ) of variance
    ``2 / fan_in``, σ corrected for the truncation."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=gen)
        bad = t.abs() > 2.0
        while bool(bad.any()):
            t[bad] = torch.randn(int(bad.sum()), generator=gen,
                                 device=t.device, dtype=t.dtype)
            bad = t.abs() > 2.0
        t.mul_(std)


class SwitchFFN(nn.Module):
    """Top-k routed expert FFN, ``[B, S, E]`` in and out (module
    docstring).

    ``expert_act="gelu"``: two GELU layers with biases, hidden
    ``mlp_ratio·E`` (``w1 [N, E, H]``, ``b1 [N, H]``, ``w2 [N, H, E]``,
    ``b2 [N, E]``); ``"swiglu"``: ``w2·(silu(x·w1) ⊙ (x·w3))``, bias-free,
    hidden ``hidden_dim`` (the Mixtral expert). The weights are
    expert-major, in the JAX layout; the router is a biased ``Linear``
    ``E → N`` computed in f32. Each forward leaves what the JAX module
    sows in :attr:`sown`: ``{"losses": {"moe_aux_loss": ...},
    "metrics": {"moe_drop_rate": ...}}`` (0-d f32 tensors).
    """

    def __init__(self, embed_dim: int, num_experts: int, *,
                 mlp_ratio: int = 4, hidden_dim: Optional[int] = None,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 expert_act: str = "gelu", normalize_gates: bool = True,
                 aux_loss_weight: float = 0.01, eval_dropless: bool = True,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        n = num_experts
        if not 1 <= top_k <= n:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={n}]")
        if expert_act not in ("gelu", "swiglu"):
            raise ValueError(f"unknown expert_act {expert_act!r}")
        param_dtype = param_dtype or dtype
        hidden = hidden_dim if hidden_dim is not None else embed_dim * mlp_ratio
        self.num_experts = n
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.expert_act = expert_act
        self.normalize_gates = normalize_gates
        self.aux_loss_weight = aux_loss_weight
        self.eval_dropless = eval_dropless
        self.dtype = dtype
        self.hidden = hidden
        # Expert parallelism (``bind_experts``): this module's experts are
        # ``expert_offset .. expert_offset + n_local - 1``.
        self.expert_group = None
        self.expert_offset = 0
        self.n_local = n
        self.router = nn.Linear(embed_dim, n, bias=True, dtype=param_dtype,
                                device=device)

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=param_dtype,
                                            device=device))

        self.w1 = param(n, embed_dim, hidden)
        if expert_act == "swiglu":
            self.w3 = param(n, embed_dim, hidden)
        else:
            self.b1 = param(n, hidden)
        self.w2 = param(n, hidden, embed_dim)
        if expert_act == "gelu":
            self.b2 = param(n, embed_dim)
        self.sown: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX initializers: He normal over the experts' weights with
        the expert dimension out of the fan-in (dim 1 is the fan-in),
        zero biases; the router normal with std ``E ** -0.5`` and a zero
        bias."""
        with torch.no_grad():
            e = self.router.in_features
            self.router.weight.normal_(0.0, e ** -0.5, generator=gen)
            self.router.bias.zero_()
            for name in ("w1", "w3", "w2"):
                w = getattr(self, name, None)
                if w is not None:
                    _he_normal_(w, w.shape[1], gen)
            for name in ("b1", "b2"):
                b = getattr(self, name, None)
                if b is not None:
                    b.zero_()

    def bind_experts(self, group, offset: int, n_local: int) -> None:
        """Hold experts ``offset .. offset + n_local - 1`` (the caller has
        cut the weights to them) and sum the partial outputs over
        ``group``."""
        self.expert_group = group
        self.expert_offset = offset
        self.n_local = n_local

    def routing(self, x: torch.Tensor, train: bool = True,
                seq=None) -> Routing:
        """The router and the choices for ``x`` ``[B, S, E]`` (this
        shard's tokens under ``seq``: the capacity is the whole row's)."""
        b, s, _ = x.shape
        if _sharded(seq):
            s = s * seq.n
        logits = F.linear(x.float(), self.router.weight.float(),
                          self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)
        gate_probs = copy_to_group(probs, self.expert_group)
        cap = capacity_of(s, self.num_experts, self.top_k,
                          self.capacity_factor,
                          not train and self.eval_dropless)
        return route(probs, self.top_k, cap, self.normalize_gates,
                     gate_probs if self.expert_group is not None else None,
                     seq)

    def _experts(self, xin: torch.Tensor) -> torch.Tensor:
        """The local experts over their slots ``[B, n, C, E]``."""
        dt = self.dtype
        w1, w2 = self.w1.to(dt), self.w2.to(dt)
        if self.expert_act == "swiglu":
            gate_h = torch.einsum("bncd,ndh->bnch", xin, w1)
            up_h = torch.einsum("bncd,ndh->bnch", xin, self.w3.to(dt))
            return torch.einsum("bnch,nhd->bncd", F.silu(gate_h) * up_h, w2)
        h = F.gelu(torch.einsum("bncd,ndh->bnch", xin, w1)
                   + self.b1.to(dt)[:, None, :], approximate="tanh")
        return (torch.einsum("bnch,nhd->bncd", h, w2)
                + self.b2.to(dt)[:, None, :])

    def forward(self, x: torch.Tensor, train: bool = True,
                seq=None) -> torch.Tensor:
        """``seq``: the model's place on a ``seq`` axis above 1 when
        ``x`` holds this process's tokens of each row (module
        docstring); ``None`` routes ``x`` as the whole sequence."""
        b, s, d = x.shape
        r = self.routing(x, train, seq)
        n = self.num_experts
        if _sharded(seq):
            tokens = b * s * seq.n
            frac = psum(r.first.sum(dim=(0, 1)), seq.group) / tokens
            mean_prob = seq_sum(r.probs.sum(dim=(0, 1)), seq.group) / tokens
        else:
            tokens = b * s
            frac = r.first.mean(dim=(0, 1))
            mean_prob = r.probs.mean(dim=(0, 1))
        aux = self.aux_loss_weight * n * torch.sum(frac * mean_prob)
        drop = 1.0 - r.offset.sum() / (tokens * self.top_k)
        self.sown = {"losses": {"moe_aux_loss": aux},
                     "metrics": {"moe_drop_rate": drop}}

        dt = self.dtype
        nl, lo, cap = self.n_local, self.expert_offset, r.capacity
        xe = copy_to_group(x.to(dt), self.expert_group).reshape(b * s, d)
        trash = b * nl * cap  # the slot of every token not sent here
        rows = torch.arange(b, device=x.device)[:, None] * nl
        slots = []
        for idx, keep, pos in zip(r.expert, r.kept, r.position):
            local = idx - lo
            mine = keep & (local >= 0) & (local < nl)
            slot = (rows + local.clamp(0, nl - 1)) * cap + pos
            slots.append(torch.where(mine, slot, trash).reshape(-1))
        k = len(slots)
        xin = xe.new_zeros((trash + 1, d)).index_add(
            0, torch.cat(slots), xe.repeat(k, 1))
        out = self._experts(xin[:trash].view(b, nl, cap, d))
        flat = torch.cat([out.reshape(trash, d), out.new_zeros((1, d))])
        y = None
        for slot, g in zip(slots, r.gates):
            term = flat[slot] * g.reshape(-1, 1).to(dt)
            y = term if y is None else y + term
        return reduce_from_group(y.view(b, s, d), self.expert_group)


def sown(model: nn.Module) -> Dict[str, Dict[str, List[torch.Tensor]]]:
    """Collect and clear what the model's modules sowed in their last
    forward: ``{"losses": {name: [values]}, "metrics": {...}}``, values
    in module order."""
    out: Dict[str, Dict[str, List[torch.Tensor]]] = {"losses": {},
                                                     "metrics": {}}
    for m in model.modules():
        got = getattr(m, "sown", None)
        if not got:
            continue
        for kind, values in got.items():
            for name, v in values.items():
                out[kind].setdefault(name, []).append(v)
        m.sown = None
    return out
