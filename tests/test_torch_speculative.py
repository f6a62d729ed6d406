"""The port's speculative decoding (`pddl_tpu_torch/models/speculative.py`)
against the JAX package's on the CPU, from the same bridged `tiny_llama`
weights and the same seeded numpy inputs.

- `ngram_drafts` equals the JAX function exactly: a scalar and a `[B]`
  position, no match, a match at the buffer's start, `cur_pos < ngram -
  1` (a negative slice start, which `lax.dynamic_slice` counts from the
  end) and starts past the buffer's edge, plus a seeded sweep;
- greedy `generate_speculative` is token-exact with the JAX one and with
  the port's `generate` over a grid of `draft_len` and `ngram`, on
  repetitive and random prompts at B 2, and its `ticks` equal JAX's;
- speculative sampling: `top_k=1` equals greedy; the marginals of the
  first two verified tokens over 4,000 rows lie within a chi-square bound
  (df + 6·sqrt(2·df), over bins of expected count >= 5) of the exact
  filtered distributions; one seed gives one stream;
- the argument checks in the JAX words, the ring-cache refusal, a
  full-cache sliding-window model accepted, `strategy=` (one process),
  and `param_transform=` over `variables=`;
- the decode module at the cache's edge: a `[B]` index with one row at
  `max_len - 2` and a 5-token block writes the positions before the edge
  and drops the rest, as the JAX scatter does (logits and caches against
  the JAX decode module's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.models.gpt import _decode_cache_shapes
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.models.speculative import generate_speculative as jax_spec
from pddl_tpu.models.speculative import ngram_drafts as jax_ngram_drafts
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.gpt import decode_cache, filtered_logits, generate
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.models.speculative import (
    generate_speculative,
    ngram_drafts,
)

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


@pytest.fixture(scope="module")
def pair64():
    return _pair(max_len=64)


def _repetitive(b, p, seed=0):
    """Rows that repeat a short random motif, so n-gram drafts hit."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(b):
        motif = rng.randint(0, V, rng.randint(3, 6))
        rows.append(np.resize(motif, p))
    return np.stack(rows).astype(np.int32)


def _random(b, p, seed=0):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(np.int32)


# ------------------------------------------------------------ ngram_drafts
_BUF = np.array([[1, 2, 3, 4, 1, 2, 3, 9, 9, 1, 2, 3],
                 [5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5],
                 [7, 8, 0, 1, 2, 4, 6, 3, 1, 2, 4, 0]], np.int32)


@pytest.mark.parametrize("cur_pos,ngram,draft_len", [
    (11, 3, 4),                       # scalar: the latest earlier match
    (np.array([11, 6, 10]), 3, 4),    # per-row positions
    (np.array([2, 2, 2]), 3, 2),      # no usable earlier window
    (np.array([6, 4, 9]), 3, 3),      # a match at the buffer's start
    (np.array([1, 0, 1]), 3, 2),      # cur_pos < ngram - 1
    (0, 2, 3),                        # scalar cur_pos < ngram - 1
    (np.array([11, 30, -3]), 2, 5),   # starts past the edge both ways
    (40, 4, 6),                       # scalar past the edge
], ids=["scalar", "per_row", "no_match", "match_at_start", "short_prefix",
        "short_prefix_scalar", "past_edge", "past_edge_scalar"])
def test_ngram_drafts_equal_jax(cur_pos, ngram, draft_len):
    want = np.asarray(jax_ngram_drafts(jnp.asarray(_BUF), jnp.asarray(cur_pos)
                                       if isinstance(cur_pos, np.ndarray)
                                       else cur_pos, ngram, draft_len))
    got = ngram_drafts(torch.from_numpy(_BUF), torch.from_numpy(cur_pos)
                       if isinstance(cur_pos, np.ndarray) else cur_pos,
                       ngram, draft_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_drafts_sweep_equals_jax():
    """60 seeded [3, 20] buffers over a 3-token alphabet (many matches),
    random widths, scalar and per-row positions from -24 to 24."""
    rng = np.random.RandomState(0)
    b, length = 3, 20
    jitted = jax.jit(jax_ngram_drafts, static_argnums=(2, 3))
    for trial in range(60):
        ngram, draft_len = rng.randint(1, 5), rng.randint(1, 6)
        toks = rng.randint(0, 3, (b, length)).astype(np.int32)
        if trial % 3 == 0:
            pos = int(rng.randint(-length - 4, length + 5))
            jpos, tpos = pos, pos
        else:
            pos = rng.randint(-length - 4, length + 5, b).astype(np.int32)
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        want = np.asarray(jitted(jnp.asarray(toks), jpos, ngram, draft_len))
        got = ngram_drafts(torch.from_numpy(toks), tpos, ngram, draft_len)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"trial {trial}")


# ------------------------------------------------------------- greedy loop
@pytest.mark.parametrize("draft_len,ngram", [(1, 1), (3, 2), (7, 3), (4, 5)])
@pytest.mark.parametrize("kind", ["repetitive", "random"])
def test_greedy_speculative_is_token_exact(pair64, draft_len, ngram, kind):
    jm, params, tm = pair64
    prompt = (_repetitive if kind == "repetitive" else _random)(2, 12, seed=3)
    new = 24
    ref, jstats = jax_spec(jm, {"params": params}, jnp.asarray(prompt), new,
                           draft_len=draft_len, ngram=ngram,
                           return_stats=True)
    got, stats = generate_speculative(tm, prompt, new, draft_len=draft_len,
                                      ngram=ngram, return_stats=True)
    assert got.dtype == torch.int32 and got.shape == (2, 12 + new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(),
                                  generate(tm, prompt, new).numpy())
    assert stats == jstats
    assert stats["emitted"] == new
    assert stats["ticks"] <= new - 1


def test_greedy_speculative_accepts_drafts_on_repetitive_text(pair64):
    """A B 1 stream whose greedy continuation loops: the drafts hit, so
    ticks fall well under the tokens emitted (and still equal JAX's)."""
    jm, params, tm = pair64
    prompt = _repetitive(1, 16, seed=11)
    ref = generate(tm, prompt, 40)
    got, stats = generate_speculative(tm, prompt, 40, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    _, jstats = jax_spec(jm, {"params": params}, jnp.asarray(prompt), 40,
                         return_stats=True)
    assert stats == jstats
    assert stats["tokens_per_tick"] > 1.5


# ---------------------------------------------------------------- sampling
def test_top_k_1_sampling_equals_greedy(pair64):
    """A one-token filter makes every draft's acceptance probability 0
    or 1: the accept, residual and bonus draws all reduce to the argmax."""
    _, _, tm = pair64
    prompt = _repetitive(3, 10, seed=5)
    gen = torch.Generator().manual_seed(0)
    for draft_len in (1, 4):
        got = generate_speculative(tm, prompt, 20, temperature=0.7, top_k=1,
                                   generator=gen, draft_len=draft_len)
        np.testing.assert_array_equal(got.numpy(),
                                      generate(tm, prompt, 20).numpy())


def _chi2_within_bound(counts, probs, n):
    """Pearson's statistic over bins of expected count >= 5 (the rest
    pooled), against df + 6·sqrt(2·df)."""
    expected = probs * n
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    keep = exp > 0
    stat = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    df = int(keep.sum()) - 1
    return stat, df + 6 * np.sqrt(2 * df)


@pytest.mark.parametrize("filt", [dict(temperature=1.0),
                                  dict(temperature=0.8, top_p=0.9)],
                         ids=["t1", "t0.8_top_p0.9"])
def test_speculative_sampling_marginals(pair64, filt):
    """4,000 rows of one repetitive prompt, 3 new tokens: the first is the
    prefill's draw, the next two come out of verify windows (accepted
    drafts, residual draws and kept drafts). Their marginals against the
    exact ones, computed from the model's filtered conditionals."""
    _, _, tm = pair64
    n = 4000
    prompt = _repetitive(1, 9, seed=2)
    gen = torch.Generator().manual_seed(1)
    out = generate_speculative(tm, np.repeat(prompt, n, axis=0), 3,
                               generator=gen, draft_len=3, **filt)
    x = out[:, 9:].long()
    with torch.no_grad():
        p1 = torch.softmax(filtered_logits(tm(torch.tensor(prompt))[:, -1],
                                           **filt), -1)[0]
        seq1 = torch.cat([torch.tensor(prompt).repeat(V, 1),
                          torch.arange(V)[:, None]], 1)
        p2 = torch.softmax(filtered_logits(tm(seq1)[:, -1], **filt), -1)
        seq2 = torch.cat([seq1.repeat_interleave(V, 0),
                          torch.arange(V).repeat(V)[:, None]], 1)
        p3 = torch.softmax(filtered_logits(tm(seq2)[:, -1], **filt),
                           -1).view(V, V, V)
    m2 = p1 @ p2                                   # P(x2)
    m3 = torch.einsum("a,ab,abc->c", p1, p2, p3)   # P(x3)
    for pos, marg in ((0, p1), (1, m2), (2, m3)):
        counts = np.bincount(x[:, pos].numpy(), minlength=V)
        marg = marg.double().numpy()
        assert counts[marg == 0].sum() == 0, f"token {pos} outside filter"
        stat, bound = _chi2_within_bound(counts, marg, n)
        assert stat < bound, (pos, stat, bound)


def test_speculative_sampling_is_deterministic_under_one_seed(pair64):
    _, _, tm = pair64
    prompt = _random(2, 8, seed=9)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate_speculative(tm, prompt, 16, temperature=0.9,
                                    top_p=0.95, generator=gen).numpy()
    np.testing.assert_array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))


# --------------------------------------------------------- checks, refusals
@pytest.mark.parametrize("kw,match", [
    (dict(prompt=np.zeros((1, 0), np.int32)), "non-empty prompt"),
    (dict(max_new_tokens=0), "max_new_tokens must be >= 1"),
    (dict(draft_len=0), "draft_len must be >= 1"),
    (dict(ngram=0), "ngram must be >= 1"),
    (dict(temperature=0.8), "temperature sampling needs an rng key"),
    (dict(top_k=3), "require temperature > 0"),
    (dict(top_p=0.9), "require temperature > 0"),
    (dict(max_new_tokens=50, draft_len=8), "exceed max_len 64"),
])
def test_argument_errors_match_jax(pair64, kw, match):
    jm, params, tm = pair64
    args = dict(prompt=_random(1, 7), max_new_tokens=4)
    args.update(kw)
    prompt, new = args.pop("prompt"), args.pop("max_new_tokens")
    with pytest.raises(ValueError, match=match):
        jax_spec(jm, {"params": params}, jnp.asarray(prompt), new, **args)
    with pytest.raises(ValueError, match=match):
        generate_speculative(tm, prompt, new, **args)


def test_ring_cache_refused_and_full_cache_window_accepted():
    """A window whose ring (the window rounded up to 128) is under
    ``max_len`` is refused in both packages; one whose ring would not be
    (a full-length cache) speculates, token-exact with the JAX one."""
    jm, params, tm = _pair(max_len=512, sliding_window=8)
    assert tm.uses_ring_cache
    prompt = _random(1, 6)
    with pytest.raises(NotImplementedError, match="cannot be rewound"):
        jax_spec(jm, {"params": params}, jnp.asarray(prompt), 4)
    with pytest.raises(NotImplementedError, match="cannot be rewound"):
        generate_speculative(tm, prompt, 4)
    jm, params, tm = _pair(max_len=64, sliding_window=6)
    assert not tm.uses_ring_cache
    prompt = _repetitive(2, 14, seed=8)
    ref = jax_spec(jm, {"params": params}, jnp.asarray(prompt), 20,
                   draft_len=4)
    got = generate_speculative(tm, prompt, 20, draft_len=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw,item", [(dict(strategy=object()), "item 7"),
                                     (dict(param_transform=abs), "item 3")])
def test_unported_options_refused(pair64, kw, item):
    """``strategy`` (item 7) is ported: a one-process tensor-parallel
    strategy speculates as without it (two processes: tests/
    test_torch_tensor_parallel.py) and refuses ``param_transform`` as the
    JAX function does. ``param_transform`` (item 3, int8 serving) is
    ported: it transforms the ``variables`` passed with it (an identity
    over the model's own weights speculates as without it) and alone
    raises, having nothing to transform."""
    if "strategy" in kw:
        from pddl_tpu_torch.parallel import TensorParallelStrategy

        tm, tp = pair64[2], TensorParallelStrategy(device="cpu")
        want = generate_speculative(tm, _random(1, 4), 6, draft_len=3)
        got = generate_speculative(tm, _random(1, 4), 6, draft_len=3,
                                   strategy=tp)
        assert torch.equal(got, want)
        with pytest.raises(NotImplementedError, match="unsharded-only"):
            generate_speculative(tm, _random(1, 4), 2, strategy=tp,
                                 variables={"params": tm.state_dict()},
                                 param_transform=lambda p: p)
        return
    if "param_transform" in kw:
        tm = pair64[2]
        want = generate_speculative(tm, _random(1, 4), 6, draft_len=3)
        got = generate_speculative(tm, _random(1, 4), 6, draft_len=3,
                                   variables={"params": tm.state_dict()},
                                   param_transform=lambda p: p)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="param_transform transforms"):
            generate_speculative(tm, _random(1, 4), 2, **kw)
        return
    with pytest.raises(NotImplementedError, match=item):
        generate_speculative(pair64[2], _random(1, 4), 2, **kw)


# -------------------------------------------------- the cache-edge repair
def test_per_row_block_at_the_cache_edge_matches_jax(pair64):
    """Rows at positions [10, max_len - 2, 30] take a 5-token block: the
    second row writes positions 62 and 63 and drops 64..66, as the JAX
    scatter drops them. Logits at the positions inside the cache and the
    whole cache equal the JAX decode module's."""
    jm, params, tm = pair64
    dec = jm.clone(decode=True)
    apply = jax.jit(lambda v, x: dec.apply(v, x, train=False,
                                           mutable=["cache"]))
    b, max_len = 3, 64
    fill = _random(b, max_len, seed=12)
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          _decode_cache_shapes(dec, b))
    _, mut = apply({"params": params, "cache": jcache},
                   jnp.asarray(fill[:, :60]))
    cache = decode_cache(tm, b)
    with torch.no_grad():
        tm(torch.tensor(fill[:, :60]), cache=cache, cache_index=0)
    pos = np.array([10, max_len - 2, 30], np.int32)
    block = _random(b, 5, seed=13)
    jc = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(pos) if str(path[-1].key) == "cache_index"
                         else x), mut["cache"])
    ref, mut = apply({"params": params, "cache": jc}, jnp.asarray(block))
    with torch.no_grad():
        got = tm(torch.tensor(block), cache=cache,
                 cache_index=torch.tensor(pos), max_index=int(pos.max()))
    ref = np.asarray(ref)
    inside = np.arange(5)[None, :] + pos[:, None] < max_len
    np.testing.assert_allclose(got.numpy()[inside], ref[inside], rtol=1e-5,
                               atol=1e-5)
    for blk, leaves in cache.items():
        for name, leaf in leaves["attn"].items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(mut["cache"][blk]["attn"][name]),
                rtol=1e-5, atol=1e-5, err_msg=f"{blk}.{name}")
    # Without the host bound the port reads it with one sync: same result.
    cache2 = decode_cache(tm, b)
    with torch.no_grad():
        tm(torch.tensor(fill[:, :60]), cache=cache2, cache_index=0)
        got2 = tm(torch.tensor(block), cache=cache2,
                  cache_index=torch.tensor(pos))
    np.testing.assert_array_equal(got2.numpy()[inside], got.numpy()[inside])
    with torch.no_grad(), pytest.raises(ValueError, match="runs past"):
        tm(torch.tensor(block), cache=cache2, cache_index=max_len - 2)
