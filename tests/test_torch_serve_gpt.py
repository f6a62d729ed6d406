"""The port's serving engine on a GPT (`ServeEngine` over
`pddl_tpu_torch/models/gpt.GPT`) against the JAX engine on the CPU, from
the same bridged `tiny_gpt` weights (vocabulary 32, `max_len` 64).

- Both modes, the prefix cache on and off: step for step the same
  tokens, live slots and queue depth as the JAX engine, every stream
  equal to `ref_greedy` (the JAX `generate`) and to the port's
  `generate`.
- `spec_k=4` with n-gram drafts (row and paged) and with a depth-1 GPT
  draft model (paged): the same, with one stream ending at `max_len`,
  so its last windows reach past the cache, where the port clamps the
  position lookup the JAX package fills with NaN.
- Tenancy: a base stream, an adapter and an adapter under a schema, step
  for step the JAX tenant engine's tokens; the adapted stream equals
  `generate` over the merged (biased) head.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.tenant import AdapterRegistry as JaxRegistry
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.models.gpt import generate, tiny_gpt
from pddl_tpu_torch.ops.lora import merge_lora_into_head
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import FinishReason
from pddl_tpu_torch.serve.tenant import (
    AdapterRegistry,
    TenantConfig,
    compile_constraint,
)

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V, MAX_LEN = 32, 64
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))
SCHEMA = {"kind": "json_schema", "schema": {
    "type": "object", "properties": {"ab": {"type": "boolean"}}}}


def _port(params, depth=2):
    tm = tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=depth, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params)))
    return tm


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    jd = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=1)
    dparams = {k: v for k, v in params.items() if k != "block1"}
    return dict(jm=jm, jv={"params": params}, jd=jd,
                jdv={"params": dparams}, tm=_port(params),
                td=_port(dparams, 1))


def _run(engines, wave):
    """Submit (prompt, new, submit keywords) to every engine and step them
    in lockstep until both drain."""
    trace = {name: [] for name in engines}
    handles = {name: [] for name in engines}
    for name, eng in engines.items():
        for prompt, n, *kw in wave:
            handles[name].append(eng.submit(prompt, n, **(kw[0] if kw
                                                            else {})))
    while any(e.has_work for e in engines.values()):
        for name, eng in engines.items():
            trace[name].append((eng.step(), eng.live_slots,
                                eng.scheduler.depth))
    return trace, handles


def _loop(seed, n):
    rng = np.random.RandomState(seed)
    return np.resize(rng.randint(0, V, rng.randint(3, 6)), n)


def _wave():
    rng = np.random.RandomState(3)
    loop = _loop(1, 20)
    return [(loop, MAX_LEN - 20), (rng.randint(0, V, 17), 12),
            (np.concatenate([loop[:12], _loop(2, 6)]), 9), (loop, 7),
            (rng.randint(0, V, 5), 1)]


@pytest.mark.parametrize("mode", ["row", "row_noprefix", "paged"])
def test_engine_token_exact_vs_jax_and_generate(models, mode):
    kw = dict(max_slots=3, prefill_len=24, prefix_block_size=4,
              paged=mode == "paged")
    if mode == "row_noprefix":
        kw["prefix_cache_blocks"] = 0
    engines = {"jax": JaxServeEngine(models["jm"], models["jv"],
                                     preempt_cap=0, **kw),
               "port": ServeEngine(models["tm"], device="cpu", **kw)}
    trace, handles = _run(engines, _wave())
    assert trace["port"] == trace["jax"]
    for hp, hj, (prompt, n) in zip(handles["port"], handles["jax"], _wave()):
        assert hp.tokens == hj.tokens
        assert hp.finish_reason is FinishReason.LENGTH
        want = generate(models["tm"], prompt[None], n)[0, len(prompt):]
        assert hp.tokens == want.tolist()
    assert handles["port"][0].tokens == ref_greedy(
        models["jm"], models["jv"], _wave()[0][0], _wave()[0][1])
    assert engines["port"].prefix_cache_enabled == (mode != "row_noprefix")
    if mode != "row_noprefix":
        assert engines["port"].metrics.prefix_hits > 0


@pytest.mark.parametrize("mode", ["row", "paged", "draft"])
def test_spec_engine_token_exact_to_max_len(models, mode):
    kw = dict(max_slots=3, prefill_len=24, prefix_block_size=4, spec_k=4,
              paged=mode != "row")
    jkw, tkw = dict(kw), dict(kw)
    if mode == "draft":
        jkw.update(spec_draft_model=models["jd"],
                   spec_draft_variables=models["jdv"])
        tkw["spec_draft_model"] = models["td"]
    engines = {"jax": JaxServeEngine(models["jm"], models["jv"],
                                     preempt_cap=0, **jkw),
               "port": ServeEngine(models["tm"], device="cpu", **tkw)}
    port = engines["port"]
    deepest, verify = [], port._verify

    def spy(*args):
        deepest.append(int(port._positions.max()))
        return verify(*args)
    port._verify = spy
    trace, handles = _run(engines, _wave())
    assert max(deepest) + 4 >= MAX_LEN  # a window ran past the cache
    assert trace["port"] == trace["jax"]
    for hp, hj, (prompt, n) in zip(handles["port"], handles["jax"], _wave()):
        assert hp.tokens == hj.tokens
        assert (hp.spec_drafted, hp.spec_accepted) == (hj.spec_drafted,
                                                       hj.spec_accepted)
        want = generate(models["tm"], prompt[None], n)[0, len(prompt):]
        assert hp.tokens == want.tolist()
    assert len(handles["port"][0].tokens) + 20 == MAX_LEN
    assert port.metrics.snapshot()["spec_accepted_tokens"] > 0


@pytest.mark.parametrize("mode", ["row", "paged"])
def test_tenant_engine_token_exact_vs_jax(models, mode):
    regs = {"jax": JaxRegistry(32, V, rank=4),
            "port": AdapterRegistry(32, V, rank=4)}
    for reg in regs.values():
        reg.register_random("acme", seed=100, scale=0.1)
    kw = dict(max_slots=3, prefill_len=16, prefix_block_size=4,
              paged=mode == "paged")
    engines = {
        "jax": JaxServeEngine(models["jm"], models["jv"], preempt_cap=0,
                              tenant=JaxTenantConfig(
                                  registry=regs["jax"],
                                  token_strings=VOCAB32), **kw),
        "port": ServeEngine(models["tm"], device="cpu",
                            tenant=TenantConfig(registry=regs["port"],
                                                token_strings=VOCAB32),
                            **kw)}
    base = (np.arange(11) * 3 + 2) % V
    wave = [(base, 5), (base, 5, {"adapter": "acme"}),
            (base, 12, {"adapter": "acme", "constraint": SCHEMA})]
    trace, handles = _run(engines, wave)
    assert trace["port"] == trace["jax"]
    for hp, hj in zip(handles["port"], handles["jax"]):
        assert hp.tokens == hj.tokens
    ad = regs["port"].get("acme")
    merged = merge_lora_into_head(models["tm"], ad.a, ad.b)
    assert handles["port"][1].tokens == generate(
        merged, base[None], 5)[0, len(base):].tolist()
    assert handles["port"][0].tokens == generate(
        models["tm"], base[None], 5)[0, len(base):].tolist()
    done = handles["port"][2]
    fsm = compile_constraint(SCHEMA, VOCAB32)
    assert done.finish_reason in (FinishReason.GRAMMAR, FinishReason.LENGTH)
    if done.finish_reason is FinishReason.GRAMMAR:
        assert fsm.accepts(done.tokens)
