"""The optax update rules that ``torch.optim`` lacks or defines otherwise,
as ``torch.optim.Optimizer`` subclasses (used by
:func:`pddl_tpu_torch.train.state.make_optimizer`).

Each follows its optax chain step for step, not torch's namesake:

- :class:`RMSprop` — ``optax.rmsprop``: ``nu = decay·nu + (1-decay)·g²``
  from ``initial_scale``, the update ``g / sqrt(nu + eps)`` (eps INSIDE
  the root unless ``eps_in_sqrt=False``; torch's ``alpha`` is 0.99 and
  its eps outside), optionally centered, bias-corrected and with a
  momentum trace after the learning rate;
- :class:`Adagrad` — ``optax.adagrad``: the sum of squares starts at
  ``initial_accumulator_value`` (0.1; torch starts at 0), the update
  ``g / sqrt(sum + eps)``;
- :class:`LAMB` — ``optax.lamb``: Adam's moments (eps outside the root),
  plus ``weight_decay · p`` on the group's decayed parameters, scaled by
  the trust ratio ``||p|| / ||u||`` (1 where either norm is 0);
- :class:`LARS` — ``optax.lars``: ``g + weight_decay · p``, scaled by
  ``trust_coefficient · ||p|| / (||u|| + eps)`` (1 where either norm is
  0), times the learning rate, then a momentum trace.

Norms are over each parameter as a whole, as optax takes them over each
leaf. A parameter group's ``weight_decay`` (LAMB, LARS) and
``trust_ratio`` (LARS) flags carry optax's masks.
"""

from __future__ import annotations

import torch


def _trust(param_norm: torch.Tensor, update_norm: torch.Tensor,
           ratio: torch.Tensor) -> torch.Tensor:
    zero = (param_norm == 0) | (update_norm == 0)
    return torch.where(zero, torch.ones_like(ratio), ratio)


class _Rule(torch.optim.Optimizer):
    """Shared loop: ``_update(group, p, g, state)`` returns the additive
    update of ``p`` (optax's ``updates``, learning rate included)."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                p.add_(self._update(group, p, p.grad, self.state[p]))
        return loss


class RMSprop(_Rule):
    def __init__(self, params, lr: float, *, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0,
                 eps_in_sqrt: bool = True, centered: bool = False,
                 momentum=None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
            eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
            nesterov=nesterov, bias_correction=bias_correction))

    def _update(self, group, p, g, state):
        d, eps = group["decay"], group["eps"]
        centered, momentum = group["centered"], group["momentum"]
        if not state:
            state["step"] = 0
            state["nu"] = torch.full_like(p, group["initial_scale"])
            if centered:
                state["mu"] = torch.zeros_like(p)
            if momentum is not None:
                state["trace"] = torch.zeros_like(p)
        state["step"] += 1
        nu = state["nu"].mul_(d).add_((1 - d) * g.square())
        c = 1 - d ** state["step"] if group["bias_correction"] else 1.0
        var = nu / c
        if centered:
            mu = state["mu"].mul_(d).add_((1 - d) * g)
            var = var - (mu / c).square()
        if group["eps_in_sqrt"]:
            u = g * torch.rsqrt(var + eps)
        else:
            u = g / (var.sqrt() + eps)
        u = -group["lr"] * u
        if momentum is None:
            return u
        t = state["trace"].mul_(momentum).add_(u)
        return u + momentum * t if group["nesterov"] else t.clone()


class Adagrad(_Rule):
    def __init__(self, params, lr: float, *,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    def _update(self, group, p, g, state):
        if not state:
            state["sum"] = torch.full_like(
                p, group["initial_accumulator_value"])
        acc = state["sum"].add_(g.square())
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                          torch.zeros_like(acc))
        return -group["lr"] * (inv * g)


class LAMB(_Rule):
    def __init__(self, params, lr: float, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    def _update(self, group, p, g, state):
        b1, b2 = group["b1"], group["b2"]
        if not state:
            state["step"] = 0
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
        state["step"] += 1
        t = state["step"]
        mu = state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = state["nu"].mul_(b2).add_((1 - b2) * g.square())
        u = (mu / (1 - b1 ** t)) / (
            torch.sqrt(nu / (1 - b2 ** t) + group["eps_root"]) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        return -group["lr"] * (u * _trust(pn, un, pn / un))


class LARS(_Rule):
    def __init__(self, params, lr: float, *, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001, eps: float = 0.0,
                 momentum: float = 0.9, nesterov: bool = False,
                 trust_ratio: bool = True):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay,
            trust_coefficient=trust_coefficient, eps=eps, momentum=momentum,
            nesterov=nesterov, trust_ratio=trust_ratio))

    def _update(self, group, p, g, state):
        if not state:
            state["trace"] = torch.zeros_like(p)
        u = g + group["weight_decay"] * p if group["weight_decay"] else g
        if group["trust_ratio"]:
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = group["trust_coefficient"] * pn / (un + group["eps"])
            u = u * _trust(pn, un, ratio)
        u = -group["lr"] * u
        t = state["trace"].mul_(group["momentum"]).add_(u)
        return u + group["momentum"] * t if group["nesterov"] else t.clone()
