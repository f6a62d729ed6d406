"""int8 serving in the port's engine (`ServeEngine(model, {"params":
quantize_int8(model)}, param_transform=dequantize)`) on the CPU: the
twins of the JAX package's five int8 serving tests
(`test_serve_engine.py`, `test_serve_spec.py`, `test_serve_tenant.py`,
`test_serve_paged.py`, `test_prefix_cache.py`), at `min_elems=128` over
bridged tiny GPT and tiny Llama weights (vocabulary 32, `max_len` 64).
Each int8 stream equals the port's `generate` over the dense dequantized
weights, token for token, and the first ones also `ref_greedy` (the JAX
`generate`) over the JAX package's own dequantized tree — the port's
dequant is bitwise the JAX one (`tests/test_torch_quant.py`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.ops.quant import dequantize as jax_dequantize
from pddl_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from pddl_tpu_torch.bridge import gpt_params_from_jax, llama_params_from_jax
from pddl_tpu_torch.models.gpt import generate, tiny_gpt
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.ops.lora import merge_lora_into_head
from pddl_tpu_torch.ops.quant import dequantize, install_params, quantize_int8
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V = 32
FAMILIES = {"gpt": (jax_tiny_gpt, tiny_gpt, gpt_params_from_jax, 0),
            "llama": (jax_tiny_llama, tiny_llama, llama_params_from_jax, 1)}
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))


@pytest.fixture(scope="module")
def setups():
    """Per family: the JAX model and its dequantized int8 params, the
    port's int8 tree, and a port model holding the dense dequantized
    weights (the reference)."""
    out = {}
    for family, (jfac, tfac, bridge, seed) in FAMILIES.items():
        jm = jfac(vocab_size=V, max_len=64)
        params = jax.tree.map(np.asarray, jm.init(
            jax.random.key(seed), jnp.ones((1, 8), jnp.int32),
            train=False)["params"])
        tm = tfac(vocab_size=V, max_len=64, device="cpu")
        tm.load_state_dict(bridge(params))
        q = quantize_int8(tm, min_elems=128)
        dense = install_params(tfac(vocab_size=V, max_len=64, device="cpu"),
                               dequantize(q))
        jdense = {"params": jax_dequantize(
            jax_quantize_int8(params, min_elems=128))}
        out[family] = dict(jm=jm, jdense=jdense, q=q, dense=dense,
                           fresh=lambda f=tfac: f(vocab_size=V, max_len=64,
                                                  device="cpu", seed=9))
    return out


def _ref(model, prompt, n):
    return generate(model, np.asarray(prompt)[None], n)[0, len(prompt):
                                                         ].tolist()


def _int8_engine(s, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_len", 16)
    return ServeEngine(s["fresh"](), {"params": s["q"]}, device="cpu",
                       param_transform=dequantize, **kw)


def test_int8_serving_composes_through_engine(setups):
    s = setups["gpt"]
    eng = _int8_engine(s)
    prompts = [(np.arange(6) + i) % V for i in range(3)]
    handles = [eng.submit(p, 5) for p in prompts]
    eng.run(max_steps=50)
    for h, p in zip(handles, prompts):
        assert h.tokens == _ref(s["dense"], p, 5)
    assert h.tokens == ref_greedy(s["jm"], s["jdense"], prompts[-1], 5)


def test_spec_token_exact_int8(setups):
    s = setups["gpt"]
    p, n = (np.arange(9) * 5 + 1) % V, 9
    eng = _int8_engine(s, spec_k=3)
    h = eng.submit(p, n)
    eng.run(max_steps=200)
    assert h.tokens == _ref(s["dense"], p, n)
    assert h.tokens == ref_greedy(s["jm"], s["jdense"], p, n)


def test_int8_composes_with_adapters(setups):
    """The dequant runs at the head's product outside the module, before
    the LoRA delta: the adapted stream equals `generate` over the merged
    dense dequantized weights."""
    s = setups["gpt"]
    reg = AdapterRegistry(32, V, rank=4)
    reg.register_random("acme", seed=100, scale=0.1)
    eng = _int8_engine(s, tenant=TenantConfig(registry=reg,
                                              token_strings=VOCAB32))
    base = (np.arange(12) * 5 + 1) % V
    h0 = eng.submit(base, 5)
    h1 = eng.submit(base, 5, adapter="acme")
    eng.run(max_steps=200)
    assert h0.tokens == _ref(s["dense"], base, 5)
    ad = reg.get("acme")
    assert h1.tokens == _ref(merge_lora_into_head(s["dense"], ad.a, ad.b),
                             base, 5)


def _exactness_workload(s, **kw):
    """Cold admit, full-chain re-hit, partial hit."""
    eng = _int8_engine(s, **kw)
    base = (np.arange(12) * 5 + 1) % V
    sibling = np.concatenate([base[:8], (np.arange(6) + 17) % V])
    h_cold = eng.submit(base, 6)
    eng.run(max_steps=100)
    h_hit = eng.submit(base, 6)
    h_part = eng.submit(sibling, 6)
    eng.run(max_steps=100)
    want = _ref(s["dense"], base, 6)
    assert h_cold.tokens == h_hit.tokens == want
    assert h_part.tokens == _ref(s["dense"], sibling, 6)
    assert eng.metrics.prefix_hits >= 2
    return eng


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_paged_int8_token_exact(setups, family):
    eng = _exactness_workload(setups[family], paged=True)
    assert eng.metrics.copy_bytes_avoided > 0


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_int8_prefix_hit_token_exact(setups, family):
    eng = _exactness_workload(setups[family])
    assert eng.metrics.prefill_tokens_saved >= 2 * eng.prefix_block_size
