"""Parameter-update rules for bf16 parameter storage (the port of
:mod:`pddl_tpu.train.mixed_precision`).

A bf16 parameter loses every update smaller than half its ulp when the
update is rounded to nearest, and a ``torch.optim`` rule run over bf16
parameters keeps its moments in bf16 and does its arithmetic there too.
The JAX package runs the update rule in f32 whenever a parameter is
stored in bf16 (moments pinned f32 from ``init``, f32 hyperparameters)
and rounds the f32 sum into the parameter once. :class:`ParamUpdate` does
the same for any ``torch.optim`` optimizer: each bf16 parameter is handed
to the inner rule as an f32 proxy (``proxy.grad`` the f32 gradient), so
the rule's state is f32 from its first step, and the result is written
back by the mode's rounding:

==========================  =======  ==================================
mode                        bytes/p  the bf16 parameter after a step
==========================  =======  ==================================
f32 storage (no rule)            12  (the f32 parameter)
``plain``                        10  round-to-nearest of the f32 sum
``stochastic_round``             10  unbiased rounding of the f32 sum
``f32_master``                   14  the cast of an f32 master copy
==========================  =======  ==================================

(Adam's bytes per parameter: the parameter and its two f32 moments.)
``plain`` and ``stochastic_round`` make the f32 proxy from the parameter
at each step and free it after (a transient of 4 bytes a parameter);
``f32_master`` keeps it as the master. A leaf that is not bf16 is
updated by the inner rule directly, in every mode, and ``f32_master``
holds no master when no leaf is bf16.

``stochastic_round`` draws its noise from a ``torch.Generator`` on the
parameters' device, seeded with ``seed``: fresh bits for each bf16 leaf
at each step, in parameter order. The card's generator is Philox and the
JAX package's is threefry, so a stochastic-rounding run matches the JAX
one in distribution only; the rounding itself (:func:`_sr_to_bf16`) is
bit for bit the JAX rule's given the same bits.

The generator's state and the masters are part of :meth:`state_dict`, so
a checkpoint restores them. Under the ps strategy the group's parameters
are this process's slices, so the masters are sliced like the moments.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

PARAM_UPDATE_MODES = ("plain", "stochastic_round", "f32_master")


def _sr_to_bf16(x32: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Round f32 ``x32`` to bf16 stochastically with the random ``bits``
    (any integer tensor of its shape; the low 16 bits are used).

    bf16 is f32 without its low 16 mantissa bits: adding a uniform 16-bit
    integer to the f32 bit pattern and truncating rounds up with the
    probability of the truncated fraction. The sum is taken modulo 2^32
    as the JAX rule's ``uint32`` sum is, by carrying the low half into
    the high half in int32."""
    b = x32.contiguous().view(torch.int32)
    noise = (bits & 0xFFFF).to(torch.int32)
    carry = ((b & 0xFFFF) + noise) >> 16
    hi = (b >> 16) + carry
    hi = ((hi + 32768) & 0xFFFF) - 32768  # the high half, wrapped
    return (hi * 65536).view(torch.float32).to(torch.bfloat16)


def stochastic_round(x32: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """:func:`_sr_to_bf16` with 16 fresh bits an element from
    ``generator``."""
    bits = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                         device=x32.device, dtype=torch.int32)
    return _sr_to_bf16(x32, bits)


class OptimizerWrapper:
    """What a wrapper shares with the optimizer it wraps: the parameter
    groups (so the learning rate is read and written in one place), the
    state, ``zero_grad``, ``shard_sums``, and step pre-hooks
    (``fn(optimizer, args, kwargs)``, run before the wrapper's step)."""

    def __init__(self, inner):
        self.inner = inner
        self._pre_hooks = []
        self._shard_sums = {}

    @property
    def shard_sums(self):
        """A slice's sum over its tensor's slices, by target (set by the
        ps strategy; passed on to a wrapped rule that reads whole-tensor
        norms)."""
        return self._shard_sums

    @shard_sums.setter
    def shard_sums(self, sums) -> None:
        self._shard_sums = dict(sums)
        if hasattr(self.inner, "shard_sums"):
            self.inner.shard_sums = dict(sums)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def register_step_pre_hook(self, hook):
        self._pre_hooks.append(hook)

    def _run_pre_hooks(self) -> None:
        for hook in self._pre_hooks:
            hook(self, (), {})

    def targets(self):
        """The tensors the groups update (a parameter, or under the ps
        strategy this process's slice of one)."""
        return [p for g in self.param_groups for p in g["params"]]


class ParamUpdate(OptimizerWrapper):
    """``inner`` run in f32 over bf16 parameters, written back by ``mode``
    (module docstring)."""

    def __init__(self, inner, mode: str = "plain", *, seed: int = 0):
        if mode not in PARAM_UPDATE_MODES:
            raise ValueError(f"unknown param_update {mode!r}; known: "
                             f"{PARAM_UPDATE_MODES}")
        super().__init__(inner)
        self.mode = mode
        self.seed = int(seed)
        self._proxy: Dict[torch.Tensor, torch.nn.Parameter] = {}
        self._generator: Optional[torch.Generator] = None

    # -- proxies -------------------------------------------------------------
    def _ensure_proxies(self) -> None:
        sums = getattr(self.inner, "shard_sums", None)
        for p in self.targets():
            if p.dtype != torch.bfloat16 or p in self._proxy:
                continue
            q = torch.nn.Parameter(
                p.detach().float() if self.mode == "f32_master"
                else p.new_empty(0, dtype=torch.float32))
            self._proxy[p] = q
            if sums is not None and p in sums:
                sums[q] = sums[p]  # lamb/lars: the slice's whole-leaf norm

    @contextlib.contextmanager
    def _proxied(self):
        """The inner optimizer's groups hold the proxies meanwhile: its
        state is keyed by them."""
        self._ensure_proxies()
        saved = [g["params"] for g in self.param_groups]
        for g in self.param_groups:
            g["params"] = [self._proxy.get(p, p) for p in g["params"]]
        try:
            yield
        finally:
            for g, params in zip(self.param_groups, saved):
                g["params"] = params

    def generator(self, device) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=device).manual_seed(
                self.seed)
        return self._generator

    @property
    def state(self):
        """The inner state by target (a bf16 target's under its proxy)."""
        return {p: self.inner.state[self._proxy.get(p, p)]
                for p in self.targets()
                if self._proxy.get(p, p) in self.inner.state}

    def masters(self) -> Dict[torch.Tensor, torch.Tensor]:
        """``f32_master``'s master of each bf16 target."""
        if self.mode != "f32_master":
            return {}
        self._ensure_proxies()
        return {p: q.detach() for p, q in self._proxy.items()}

    # -- the step ------------------------------------------------------------
    @torch.no_grad()
    def apply(self, grads: Optional[Dict[torch.Tensor, torch.Tensor]] = None
              ) -> None:
        """One update from ``grads`` (target -> gradient, any float type;
        ``None``: the targets' ``.grad``)."""
        self._ensure_proxies()
        if grads is None:
            grads = {p: p.grad for p in self.targets() if p.grad is not None}
        saved = {}
        for p, g in grads.items():
            q = self._proxy.get(p)
            if q is None:
                saved[p] = p.grad
                p.grad = g if g.dtype == p.dtype else g.to(p.dtype)
                continue
            if self.mode != "f32_master":
                q.data = p.detach().float()
            q.grad = g.float()
        with self._proxied():
            self.inner.step()
        for p, g in saved.items():
            p.grad = g
        for p in grads:
            q = self._proxy.get(p)
            if q is None:
                continue
            if self.mode == "stochastic_round":
                p.copy_(stochastic_round(q.detach(), self.generator(p.device)))
            else:
                p.copy_(q.detach())
            q.grad = None
            if self.mode != "f32_master":
                q.data = p.new_empty(0, dtype=torch.float32)

    def step(self, closure=None):
        self._run_pre_hooks()
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.apply()
        return loss

    # -- checkpoints ---------------------------------------------------------
    def state_dict(self) -> dict:
        with self._proxied():
            inner = self.inner.state_dict()
        out = {"inner": inner, "mode": self.mode}
        if self.mode == "f32_master":
            out["masters"] = [q.detach() for q in
                              (self._proxy.get(p) for p in self.targets())
                              if q is not None]
        if self._generator is not None:
            out["generator"] = self._generator.get_state()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if state.get("mode", self.mode) != self.mode:
            raise ValueError(f"a {state['mode']!r} optimizer state cannot "
                             f"load into param_update={self.mode!r}")
        with self._proxied():
            self.inner.load_state_dict(state["inner"])
        if self.mode == "f32_master":
            proxies = [self._proxy[p] for p in self.targets()
                       if p in self._proxy]
            for q, m in zip(proxies, state["masters"], strict=True):
                q.data = m.to(device=q.device, dtype=torch.float32,
                              copy=True)
        if "generator" in state:
            device = self.targets()[0].device
            self.generator(device).set_state(state["generator"].cpu())


def wrap_param_update(optimizer, mode: str, *, seed: int = 0) -> ParamUpdate:
    """``optimizer`` under a :data:`PARAM_UPDATE_MODES` rule."""
    return ParamUpdate(optimizer, mode, seed=seed)
