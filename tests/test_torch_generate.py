"""The port's KV-cache decoding (`models/gpt.generate` over the row cache)
against the JAX package's on the CPU, from the same bridged `tiny_llama`
weights and the same seeded numpy prompts.

- greedy `generate` (f32), token-exact with the JAX `generate`: B 1 and
  B 3 on a full-length cache, and a sliding-window model on its rolling
  ring (`sliding_window=8`, `max_len=512`: ring 128) with a prompt longer
  than the ring, so the ring wraps in the prefill and again in decode —
  the prefill's block attends to itself through `flash_attention_lse`
  (K1's plain version here, the Pallas kernel interpreted on the JAX
  side);
- the chunked ring prefill at a nonzero index through the model's
  forward (chunks 0:80, 80:150 and 150:200 over a ring of 128): logits
  within rtol/atol 1e-5 of the JAX decode module's and of the port's own
  full forward (the case `tests/test_llama.py` holds for the JAX
  package), and the ring's K/V equal to the JAX cache's;
- the prefill's cache, its first logits and the row-path writes (a
  per-row `[B]` index and a single-token ring step) against the JAX
  decode module's cache;
- the argument checks, with the JAX function's messages, and the
  `strategy=` (a one-process tensor-parallel strategy), and `param_transform=` over `variables=`;
- sampled tokens lie in their filter (`top_k`, `top_p`), `top_k=1`
  equals greedy, and one seed gives one stream.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.models.gpt import _decode_cache_shapes
from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.gpt import (
    decode_cache,
    filtered_logits,
    generate,
)
from pddl_tpu_torch.models.llama import tiny_llama

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V = 32


def _pair(seed=1, **kw):
    """A JAX tiny Llama with its params and the port's twin."""
    jm = jax_tiny_llama(vocab_size=V, **kw)
    params = jm.init(jax.random.key(seed), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_llama(vocab_size=V, device="cpu", **kw)
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _prompt(b, p, seed=0):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(np.int32)


@pytest.mark.parametrize("b,p,new,kw", [
    (1, 7, 12, dict(max_len=64)),
    (3, 5, 10, dict(max_len=64)),
    (2, 20, 9, dict(max_len=64, sliding_window=6)),   # window, no ring
    (1, 150, 30, dict(max_len=512, sliding_window=8)),  # ring 128 wraps
], ids=["b1", "b3", "window_full_cache", "ring_wraps"])
def test_greedy_generate_is_token_exact_with_jax(b, p, new, kw):
    jm, params, tm = _pair(**kw)
    assert tm.uses_ring_cache == jm.uses_ring_cache
    prompt = _prompt(b, p)
    ref = jax_generate(jm, {"params": params}, jnp.asarray(prompt), new)
    got = generate(tm, prompt, new)
    assert got.dtype == torch.int32 and got.shape == (b, p + new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_cache(jm, b):
    return jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                        _decode_cache_shapes(jm.clone(decode=True), b))


def _assert_cache_close(cache, jcache, tol=1e-5):
    for blk, leaves in cache.items():
        for name, leaf in leaves["attn"].items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(jcache[blk]["attn"][name]),
                rtol=tol, atol=tol, err_msg=f"{blk}.{name}")


def test_ring_chunked_prefill_at_nonzero_index_matches_jax():
    """Three multi-token chunks through the ring: 0..80 (no wrap),
    80..150 (wraps the 128-ring) and 150..200 (history fully wrapped):
    each chunk merges the PRE-WRITE ring's in-window history with its own
    block; logits match the JAX decode module's and the full forward's."""
    jm, params, tm = _pair(seed=2, max_len=256, sliding_window=100)
    tokens = _prompt(1, 200, seed=17)
    full = tm(torch.tensor(tokens))
    dec = jm.clone(decode=True)
    jcache = _jax_cache(jm, 1)
    cache = decode_cache(tm, 1)
    assert cache["block0"]["attn"]["cached_key"].shape[2] == 128
    for lo, hi in ((0, 80), (80, 150), (150, 200)):
        ref, mut = dec.apply({"params": params, "cache": jcache},
                             jnp.asarray(tokens[:, lo:hi]), train=False,
                             mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tm(torch.tensor(tokens[:, lo:hi]), cache=cache,
                     cache_index=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=f"chunk {lo}:{hi}")
        np.testing.assert_allclose(got.numpy(),
                                   full[:, lo:hi].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        _assert_cache_close(cache, jcache)


def test_row_writes_match_the_jax_cache():
    """A prefill, then a step at a per-row ``[B]`` index (rows at
    different depths), on a full cache; and single-token steps on a ring
    past its wrap: logits and caches against the JAX decode module's."""
    jm, params, tm = _pair(seed=3, max_len=64)
    dec = jm.clone(decode=True)
    prompt = _prompt(3, 10, seed=4)
    jcache = _jax_cache(jm, 3)
    ref, mut = dec.apply({"params": params, "cache": jcache},
                         jnp.asarray(prompt), train=False, mutable=["cache"])
    cache = decode_cache(tm, 3)
    with torch.no_grad():
        got = tm(torch.tensor(prompt), cache=cache, cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    _assert_cache_close(cache, mut["cache"])
    pos = np.array([10, 4, 7], np.int32)  # rows at their own depths
    tok = _prompt(3, 1, seed=5)
    jc = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(pos) if str(path[-1].key) == "cache_index"
                         else x), mut["cache"])
    ref, mut = dec.apply({"params": params, "cache": jc}, jnp.asarray(tok),
                         train=False, mutable=["cache"])
    with torch.no_grad():
        got = tm(torch.tensor(tok), cache=cache,
                 cache_index=torch.tensor(pos), max_index=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    _assert_cache_close(cache, mut["cache"])

    jm, params, tm = _pair(seed=4, max_len=256, sliding_window=100)
    dec = jm.clone(decode=True)
    toks = _prompt(1, 140, seed=6)
    jcache, cache = _jax_cache(jm, 1), decode_cache(tm, 1)
    _, mut = dec.apply({"params": params, "cache": jcache},
                       jnp.asarray(toks[:, :126]), train=False,
                       mutable=["cache"])
    jcache = mut["cache"]
    with torch.no_grad():
        tm(torch.tensor(toks[:, :126]), cache=cache, cache_index=0)
        for t in range(126, 132):  # wraps the 128-slot ring at t = 128
            ref, mut = dec.apply({"params": params, "cache": jcache},
                                 jnp.asarray(toks[:, t:t + 1]), train=False,
                                 mutable=["cache"])
            jcache = mut["cache"]
            got = tm(torch.tensor(toks[:, t:t + 1]), cache=cache,
                     cache_index=t)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"position {t}")
    _assert_cache_close(cache, jcache)


def test_writes_past_the_cache_raise():
    """Where the JAX module clamps a block start at a shared index past a
    full-length cache, the port raises; a per-row write past the cache
    drops, as the JAX scatter drops it (the row before the edge is
    written, the cache past it untouched); a per-row block on a ring
    raises as in the JAX module."""
    _, _, tm = _pair(max_len=64)
    cache = decode_cache(tm, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="runs past"):
        tm(torch.zeros(2, 8, dtype=torch.long), cache=cache, cache_index=60)
    with torch.no_grad():
        out = tm(torch.zeros(2, 1, dtype=torch.long), cache=cache,
                 cache_index=torch.tensor([3, 64]))
    assert torch.isfinite(out).all()
    ck = cache["block0"]["attn"]["cached_key"]
    assert ck[0, :, 3].abs().sum() > 0
    assert ck[1].abs().sum() == 0
    _, _, ring = _pair(max_len=512, sliding_window=8)
    with torch.no_grad(), pytest.raises(ValueError, match="single-token"):
        ring(torch.zeros(2, 3, dtype=torch.long), cache=decode_cache(ring, 2),
             cache_index=torch.tensor([3, 4]))


@pytest.mark.parametrize("kw,match", [
    (dict(prompt=np.zeros((1, 0), np.int32)), "non-empty prompt"),
    (dict(max_new_tokens=60), "exceed max_len 64"),
    (dict(temperature=0.8), "temperature sampling needs an rng key"),
    (dict(top_k=3), "require temperature > 0"),
    (dict(top_p=0.9), "require temperature > 0"),
])
def test_argument_errors_match_jax(kw, match):
    jm, params, tm = _pair(max_len=64)
    args = dict(prompt=_prompt(1, 5), max_new_tokens=4)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        jax_generate(jm, {"params": params}, jnp.asarray(args["prompt"]),
                     args["max_new_tokens"],
                     **{k: v for k, v in kw.items()
                        if k not in ("prompt", "max_new_tokens")})
    with pytest.raises(ValueError, match=match):
        generate(tm, args.pop("prompt"), args.pop("max_new_tokens"), **args)


@pytest.mark.parametrize("kw,item", [
    (dict(strategy=object()), "queue 1 item 7"),
    (dict(param_transform=lambda p: p), "queue 1 item 3"),
])
def test_unported_options_are_refused(kw, item):
    """``strategy`` (queue 1 item 7) is ported: a one-process tensor
    parallel strategy decodes as ``generate`` does (two processes: tests/
    test_torch_tensor_parallel.py), and with ``param_transform`` it raises
    the JAX function's ``NotImplementedError``. ``param_transform`` (queue
    1 item 3, int8 serving) is ported: it transforms the ``variables``
    passed with it — an identity over the model's own weights decodes as
    ``generate`` does — and alone it raises, having nothing to
    transform."""
    _, _, tm = _pair(max_len=64)
    if "strategy" in kw:
        from pddl_tpu_torch.parallel import TensorParallelStrategy

        tp = TensorParallelStrategy(device="cpu")
        want = generate(tm, _prompt(1, 5), 4)
        assert torch.equal(generate(tm, _prompt(1, 5), 4, strategy=tp),
                           want)
        with pytest.raises(NotImplementedError, match="unsharded-only"):
            generate(tm, _prompt(1, 5), 4, strategy=tp,
                     variables={"params": tm.state_dict()},
                     param_transform=lambda p: p)
        return
    if "param_transform" in kw:
        want = generate(tm, _prompt(1, 5), 4)
        got = generate(tm, _prompt(1, 5), 4,
                       variables={"params": tm.state_dict()}, **kw)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="param_transform transforms"):
            generate(tm, _prompt(1, 5), 4, **kw)
        return
    with pytest.raises(NotImplementedError, match=item):
        generate(tm, _prompt(1, 5), 4, **kw)


@pytest.mark.parametrize("top_k,top_p", [(3, None), (None, 0.6), (5, 0.8)])
def test_sampled_tokens_lie_in_their_filter(top_k, top_p):
    """Each sampled token is kept by its step's filter (recomputed from a
    full forward over the generated sequence); one seed, one stream."""
    _, _, tm = _pair(seed=5, max_len=64)
    prompt, p, new, temp = _prompt(2, 6, seed=8), 6, 20, 1.3
    kw = dict(temperature=temp, top_k=top_k, top_p=top_p)
    outs = [generate(tm, prompt, new,
                     generator=torch.Generator().manual_seed(seed), **kw)
            for seed in (11, 11, 12)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    for out in (outs[0], outs[2]):
        with torch.no_grad():
            logits = tm(out[:, :-1].long())[:, p - 1:]
        keep = torch.isfinite(filtered_logits(logits, **kw))
        picked = keep.gather(-1, out[:, p:].long()[..., None])
        assert picked.all()


def test_top_k_one_equals_greedy():
    _, _, tm = _pair(seed=6, max_len=64)
    prompt = _prompt(2, 5, seed=9)
    greedy = generate(tm, prompt, 12)
    top1 = generate(tm, prompt, 12, temperature=0.7, top_k=1,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(greedy, top1)
