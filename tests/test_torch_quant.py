"""Weight-only int8 (`pddl_tpu_torch/ops/quant.py`) against the JAX
package on the CPU.

- `quantize_int8` through the weight bridge gives the JAX function's
  quantized leaf set and bitwise its `qvalue`s and scales, and
  `dequantize` bitwise its dense weights, for tiny GPT and tiny Llama at
  `min_elems` 128 and at 16, below `embed_dim` (32), where the JAX
  package quantizes GPT's `[H, D]` q/k/v biases over the heads axis;
- the twins of `tests/test_quant.py`'s first five tests: the per-channel
  error bound, the eligibility rules and the storage cut, a dead channel,
  and the `param_transform` hook of `generate` (both families) and
  `generate_speculative` — token-exact with the dense dequantized
  weights and with the JAX int8 streams;
- installed int8 stays int8: the weights are int8 parameters, the
  transform runs once a weight a forward and never for `model.device`;
- `dequantize` writes a large leaf in blocks, bitwise the one-shot
  product, and `quantize_int8` takes only a model;
- `variables=` applies to one call: after `generate` over int8 weights,
  and beside an int8 engine, the caller's model decodes as before.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.ops.quant import dequantize as jax_dequantize
from pddl_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from pddl_tpu_torch.bridge import gpt_params_from_jax, llama_params_from_jax
from pddl_tpu_torch.models.gpt import generate, tiny_gpt
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.models.speculative import generate_speculative
from pddl_tpu_torch.ops.quant import (
    dequantize,
    install_params,
    is_qleaf,
    quantize_int8,
    quantized_bytes,
)

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FAMILIES = {"gpt": (jax_tiny_gpt, tiny_gpt, gpt_params_from_jax),
            "llama": (jax_tiny_llama, tiny_llama, llama_params_from_jax)}


def _pair(family, max_len=64, seed=0):
    jfac, tfac, bridge = FAMILIES[family]
    jm = jfac(vocab_size=32, max_len=max_len)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.ones((1, 8), jnp.int32),
        train=False)["params"])
    tm = tfac(vocab_size=32, max_len=max_len, device="cpu")
    tm.load_state_dict(bridge(params))
    return jm, params, tm, bridge


def _bridge_leaves(qtree, bridge, fn, other):
    """Bridge a JAX int8 tree by one view of its leaves: ``fn(qleaf)`` for
    the int8 ones, ``other(array)`` for the rest."""
    tree = jax.tree.map(
        lambda n: fn(n) if jax_is_q(n) else other(np.asarray(n)), qtree,
        is_leaf=jax_is_q)
    return bridge(tree)


def jax_is_q(node):
    return isinstance(node, dict) and set(node) == {"qvalue", "scale", "like"}


@pytest.mark.parametrize("min_elems", [128, 16])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_quantize_equals_jax_through_the_bridge(family, min_elems):
    _, params, tm, bridge = _pair(family)
    jq = jax_quantize_int8(params, min_elems=min_elems)
    q = quantize_int8(tm, min_elems=min_elems)
    mask = _bridge_leaves(jq, bridge, lambda n: np.ones(n["qvalue"].shape,
                                                        bool),
                          lambda a: np.zeros(a.shape, bool))
    assert {k for k, v in q.items() if is_qleaf(v)} == {
        k for k, v in mask.items() if bool(v.all())}
    qv = _bridge_leaves(jq, bridge, lambda n: np.asarray(n["qvalue"]),
                        lambda a: np.zeros(a.shape, np.int8))
    scale = _bridge_leaves(
        jq, bridge, lambda n: np.broadcast_to(np.asarray(n["scale"]),
                                              n["qvalue"].shape).copy(),
        lambda a: np.zeros(a.shape, np.float32))
    dense = bridge(jax.tree.map(np.asarray, jax_dequantize(jq)))
    ours = dequantize(q)
    for name, leaf in q.items():
        torch.testing.assert_close(ours[name], dense[name], rtol=0, atol=0)
        if is_qleaf(leaf):
            assert leaf["qvalue"].dtype == torch.int8
            torch.testing.assert_close(leaf["qvalue"], qv[name], rtol=0,
                                       atol=0)
            torch.testing.assert_close(
                leaf["scale"].expand(leaf["qvalue"].shape), scale[name],
                rtol=0, atol=0)
    biases = [q[k] for k in q if k.endswith("attn.query.bias")]
    assert bool(biases) == (family == "gpt")
    assert all(is_qleaf(b) == (min_elems < 32) for b in biases)


def _linear(w):
    """A one-layer module holding ``w`` (``[out, in]``) as its weight."""
    layer = torch.nn.Linear(w.shape[1], w.shape[0], bias=False)
    layer.weight.data.copy_(w)
    return layer


def test_roundtrip_error_bounded_per_channel():
    gen = torch.Generator().manual_seed(1)
    # [out, in]: output channel j spans [0.01, 10] in scale.
    w = (torch.randn(512, 256, generator=gen)
         * torch.linspace(0.01, 10.0, 512)[:, None])
    q = quantize_int8(_linear(w), min_elems=1)
    back = dequantize(q)["weight"]
    bound = w.abs().amax(dim=1, keepdim=True) / 254.0
    assert bool(((back - w).abs() <= bound * (1 + 1e-5) + 1e-7).all())
    small_err = (back - w)[0].abs().max()
    assert small_err <= w[0].abs().max() / 254.0 + 1e-7
    assert small_err < w.abs().max() / 254.0 / 50.0
    want = jax_dequantize(jax_quantize_int8(
        {"k": jnp.asarray(w.numpy().T)}, min_elems=1))["k"]
    np.testing.assert_array_equal(back.numpy().T, np.asarray(want))


def test_eligibility_rules():
    model = tiny_gpt(vocab_size=32, max_len=64, device="cpu")
    q = quantize_int8(model, min_elems=128)
    quantized = {k for k, v in q.items() if is_qleaf(v)}
    assert not any("embed" in k for k in quantized)
    assert "head.lm_head.weight" in quantized
    assert any(k.startswith("blocks.") for k in quantized)
    assert not any(k.endswith("bias") for k in quantized)
    stats, dense = quantized_bytes(q), quantized_bytes(model.state_dict())
    assert stats["quantized_leaves"] == len(quantized) == 13
    assert stats["bytes"] < dense["bytes"]
    assert all(t.dtype == torch.float32 for t in dequantize(q).values())


def test_amax_zero_channel_is_finite():
    w = torch.zeros(8, 64)
    w[:4] = 1.0
    back = dequantize(quantize_int8(_linear(w), min_elems=1))["weight"]
    torch.testing.assert_close(back, w, rtol=0, atol=0)


def _dense_twin(family, q):
    _, tfac, _ = FAMILIES[family]
    model = tfac(vocab_size=32, max_len=96, device="cpu", seed=7)
    return install_params(model, dequantize(q))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_generate_param_transform_hook(family):
    jm, params, tm, _ = _pair(family, max_len=96)
    prompt = np.tile(np.arange(6, dtype=np.int32), (2, 2))
    q = quantize_int8(tm, min_elems=128)
    ref = generate(_dense_twin(family, q), prompt, 16)
    out = generate(tm, prompt, 16, variables={"params": q},
                   param_transform=dequantize)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    jq = jax_quantize_int8(params, min_elems=128)
    want = jax_generate(jm, {"params": jq}, jnp.asarray(prompt), 16,
                        param_transform=jax_dequantize)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_speculative_param_transform_hook():
    _, _, tm, _ = _pair("gpt", max_len=96)
    prompt = np.tile(np.arange(7, dtype=np.int32), (1, 3))[:, :18]
    q = quantize_int8(tm, min_elems=128)
    ref = generate(_dense_twin("gpt", q), prompt, 24)
    out = generate_speculative(tm, prompt, 24, variables={"params": q},
                               param_transform=dequantize)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_installed_int8_stays_int8_and_dequantizes_per_use():
    tm = tiny_gpt(vocab_size=32, max_len=64, device="cpu")
    q = quantize_int8(tm, min_elems=128)
    calls = []

    def counting(leaf):
        calls.append(1)
        return dequantize(leaf)

    install_params(tm, q, counting)
    int8 = [n for n, p in tm.named_parameters() if p.dtype == torch.int8]
    assert len(int8) == 13
    assert tm.device.type == "cpu" and not calls
    with torch.no_grad():
        tm(torch.zeros((1, 4), dtype=torch.long))
    assert len(calls) == 13
    with pytest.raises(ValueError, match="no param_transform"):
        install_params(tm, q)
    with pytest.raises(ValueError, match="do not match"):
        install_params(tm, {"head.lm_head.bias": q["head.lm_head.bias"]})
    with pytest.raises(ValueError, match="param_transform transforms"):
        generate(tm, np.zeros((1, 2), np.int32), 2,
                 param_transform=dequantize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_in_blocks_is_the_one_shot_product(monkeypatch, dtype):
    """A leaf larger than a block (here 4 rows of 96, a 1-D leaf by 40
    elements) dequantizes bitwise as ``(qvalue.float() * scale).to(like)``,
    the JAX function's formula."""
    import pddl_tpu_torch.ops.quant as quant
    gen = torch.Generator().manual_seed(2)
    model = torch.nn.Linear(96, 37, dtype=dtype)
    torch.nn.init.normal_(model.weight, generator=gen)
    leaf = quantize_int8(model, min_elems=1)["weight"]
    flat = {"qvalue": leaf["qvalue"].reshape(-1)[:999],
            "scale": torch.rand(999, generator=gen),
            "like": leaf["like"]}
    monkeypatch.setattr(quant, "_DEQUANT_BLOCK", 400)
    for node in (leaf, flat):
        want = (node["qvalue"].float() * node["scale"]).to(dtype)
        got = dequantize(node)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_quantize_int8_takes_only_a_model():
    """A ``state_dict`` would miss the JAX ranks the modules declare (a
    flat q/k/v bias is ``[H, D]`` in JAX), so it is refused."""
    model = tiny_gpt(vocab_size=32, max_len=64, device="cpu")
    with pytest.raises(TypeError, match="takes the model"):
        quantize_int8(model.state_dict(), min_elems=16)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_variables_apply_to_one_call(family):
    """``generate(variables=int8)`` leaves the model's own weights in it:
    it decodes as before, with no int8 parameter; an int8 engine built on
    it does the same, and two engines over one model with different
    trees each serve their own."""
    from pddl_tpu_torch.serve.engine import ServeEngine
    _, _, tm, _ = _pair(family, max_len=96)
    prompt = np.tile(np.arange(6, dtype=np.int32), (2, 2))
    before = generate(tm, prompt, 12)
    q = quantize_int8(tm, min_elems=128)
    generate(tm, prompt, 12, variables={"params": q},
             param_transform=dequantize)
    generate_speculative(tm, prompt, 12, variables={"params": q},
                         param_transform=dequantize)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    torch.testing.assert_close(generate(tm, prompt, 12), before, rtol=0,
                               atol=0)
    twin = _dense_twin(family, q)
    other = FAMILIES[family][1](vocab_size=32, max_len=96, device="cpu",
                                seed=5)
    engines = [ServeEngine(tm, variables, device="cpu", max_slots=2,
                           prefill_len=16, **kw)
               for variables, kw in (({"params": q},
                                      {"param_transform": dequantize}),
                                     ({"params": other.state_dict()}, {}))]
    handles = [eng.submit(prompt[0], 8) for eng in engines]
    for eng in engines:
        eng.run(max_steps=50)
    for handle, ref in zip(handles, (twin, other)):
        assert handle.tokens == generate(ref, prompt[:1], 8)[0, 12:].tolist()
    torch.testing.assert_close(generate(tm, prompt, 12), before, rtol=0,
                               atol=0)
