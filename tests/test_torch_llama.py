"""The port's Llama (`pddl_tpu_torch/models/llama.py`, `ops/rope.py`)
against the JAX Llama on the CPU, through the weight bridge.

- RoPE tables and rotations within 1e-6 for ``[S]`` and ``[B, S]``
  positions;
- full-forward logits within 1e-5 (f32, reference attention);
- the paged path — batch-1 chunk prefills into a shared pool, then eight
  batched ticks at per-row depths — logits within 1e-5 of the JAX decode
  model over the JAX paged cache;
- greedy tokens through the port's paged path equal `conftest.ref_greedy`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ref_greedy
from pddl_tpu.models.gpt import (
    prefill_row_from as jax_prefill_row_from,
    set_cache_block_tables,
    set_cache_positions,
)
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.ops.rope import apply_rope_qk as jax_apply_rope_qk
from pddl_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from pddl_tpu.serve.kvcache import paged_decode_cache as jax_paged_cache
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.gpt import prefill_row_from
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.ops.rope import apply_rope_qk, rope_cos_sin
from pddl_tpu_torch.serve.kvcache import paged_decode_cache

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BS, T = 4, 16  # pool block size and table width (64 = max_len positions)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model) with bridged weights."""
    jm = jax_tiny_llama(vocab_size=32, max_len=64)
    params = jm.init(jax.random.key(1), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_llama(vocab_size=32, max_len=64, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, {"params": params}, tm


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_rope_matches_jax(shape):
    rng = np.random.RandomState(0)
    pos = rng.randint(0, 4000, size=shape).astype(np.int32)
    for theta in (10000.0, 500000.0):
        c_ref, s_ref = jax_rope_cos_sin(jnp.asarray(pos), 16, theta=theta)
        c, s = rope_cos_sin(torch.tensor(pos), 16, theta=theta)
        np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-6)
    b, seq = 3, shape[-1]
    q = rng.randn(b, 4, seq, 16).astype(np.float32)
    k = rng.randn(b, 2, seq, 16).astype(np.float32)
    qr, kr = jax_apply_rope_qk(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(pos), theta=500000.0)
    qt, kt = apply_rope_qk(torch.tensor(q), torch.tensor(k),
                           torch.tensor(pos), theta=500000.0)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qr), atol=1e-6)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kr), atol=1e-6)


def test_full_forward_logits_match_jax(pair):
    jm, variables, tm = pair
    tokens = np.random.RandomState(1).randint(0, 32, (2, 12)).astype(
        np.int32)
    ref = jm.apply(variables, jnp.asarray(tokens), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bridge_carries_qkv_bias_and_slices_padded_vocab():
    """Qwen2-style q/k/v biases (made nonzero here) bridge as ``[Hx*D]``,
    and a ``vocab_multiple``-padded head returns only ``vocab_size``
    logits."""
    kw = dict(vocab_size=30, max_len=64, qkv_bias=True, vocab_multiple=8)
    jm = jax_tiny_llama(**kw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(2), jnp.ones((1, 8), jnp.int32),
        train=False)["params"])
    rng = np.random.RandomState(3)
    for i in range(jm.depth):
        for name in ("query", "key", "value"):
            leaf = params[f"block{i}"]["attn"][name]
            leaf["bias"] = rng.randn(*leaf["bias"].shape).astype(np.float32)
    tm = tiny_llama(**kw, device="cpu")
    tm.load_state_dict(llama_params_from_jax(params))
    tokens = rng.randint(0, 30, (2, 9)).astype(np.int32)
    ref = jm.apply({"params": params}, jnp.asarray(tokens), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(tokens))
    assert got.shape == (2, 9, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kw", [
    {}, dict(qkv_bias=True, vocab_multiple=8),
    dict(depth=4, moe_experts=4, moe_every=2),
    dict(param_dtype=torch.bfloat16)],
    ids=["dense", "qkv_bias", "routed", "bf16_storage"])
def test_every_parameter_is_drawn_from_the_seed(kw):
    """The modules are built on ``meta`` and laid out uninitialised, so
    ``init_weights`` must write every parameter: with uninitialised memory
    filled with NaN, each one comes out finite and equal to another build's
    of the same seed."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.empty(4).isnan().all()  # the fill this test relies on
        a, b = (tiny_llama(**kw, device="cpu", seed=3).state_dict()
                for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(was)
    assert a.keys() == b.keys()
    for name, t in a.items():
        assert t.float().isfinite().all(), name
        assert torch.equal(t, b[name]), name


def test_paged_prefill_and_ticks_match_jax(pair):
    """Two rows, each chunk-prefilled at batch 1 through its own table
    (row 1 continues past a chunk boundary), then eight batched ticks at
    their own depths; the same tokens are fed to both sides."""
    jm, variables, tm = pair
    dec = jm.clone(decode=True)
    n_blocks = 1 + 2 * T
    tables = np.stack([1 + np.arange(T), 1 + T + np.arange(T)]).astype(
        np.int32)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 32, 7), rng.randint(0, 32, 13)]
    jcache = jax_paged_cache(dec, n_blocks, BS)
    tcache = paged_decode_cache(tm, n_blocks, BS)
    chunk = 8
    nxt = []

    @jax.jit
    def jax_tick(cache, tokens, positions):
        cache = set_cache_positions(cache, positions)
        cache = set_cache_block_tables(cache, jnp.asarray(tables))
        logits, mutated = dec.apply(
            {"params": variables["params"], "cache": cache},
            tokens[:, None], train=False, mutable=["cache"])
        return logits, mutated["cache"]

    with torch.no_grad():
        for row, prompt in enumerate(prompts):
            for off in range(0, len(prompt), chunk):
                w = min(chunk, len(prompt) - off)
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :w] = prompt[off:off + w]
                jcache = set_cache_block_tables(jcache, tables[row:row + 1])
                jcache, jl = jax_prefill_row_from(
                    dec, variables["params"], jnp.asarray(toks), w, jcache,
                    off)
                _, tl = prefill_row_from(tm, torch.tensor(toks), w, tcache,
                                         off, torch.tensor(tables[row:row + 1]))
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            nxt.append(int(np.argmax(np.asarray(jl)[0])))
        positions = np.array([len(p) for p in prompts], np.int32)
        tokens = np.array(nxt, np.int32)
        for _ in range(8):
            jl, jcache = jax_tick(jcache, jnp.asarray(tokens),
                                  jnp.asarray(positions))
            tl = tm(torch.tensor(tokens)[:, None], cache=tcache,
                    cache_index=torch.tensor(positions),
                    block_table=torch.tensor(tables))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            tokens = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(
                np.int32)
            positions = positions + 1
    # The pools agree too (every block a row wrote, post-RoPE keys).
    for i in range(tm.depth):
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(
                tcache[f"block{i}"]["attn"][name].numpy()[1:],
                np.asarray(jcache[f"block{i}"]["attn"][name])[1:], **TOL)


def test_paged_greedy_equals_ref_greedy(pair):
    jm, variables, tm = pair
    prompt = (np.arange(11) * 7 + 3) % 32
    table = torch.arange(1, T + 1, dtype=torch.int32)[None]
    cache = paged_decode_cache(tm, T + 1, BS)
    out = []
    with torch.no_grad():
        _, logits = prefill_row_from(tm, torch.tensor(prompt[None]),
                                     len(prompt), cache, 0, table)
        pos = len(prompt)
        for _ in range(8):
            tok = int(logits[0].argmax())
            out.append(tok)
            logits = tm(torch.tensor([[tok]]), cache=cache,
                        cache_index=torch.tensor([pos]),
                        block_table=table)[:, -1]
            pos += 1
    assert out == ref_greedy(jm, variables, prompt, 8)
