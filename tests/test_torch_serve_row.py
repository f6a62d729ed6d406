"""The port's resident-row engine, `ServeEngine(paged=False)` (the default
in both packages), against the JAX one on the CPU, from the same bridged
`tiny_llama` weights.

A shared-prefix wave on 2 slots — cold prompts through the WIDE chunk,
prefix hits and a partial hit through NARROW chunks over a gathered
prefix, a pool small enough that donations evict cached chains, a
one-token request and a queue that holds requests back — with the prefix
cache on and at `prefix_cache_blocks=0` (one padded prefill per
admission). Step for step the two engines emit the same tokens with the
same live slots and queue depth; every stream equals `ref_greedy`; the
clock-free entries of the metrics snapshots are equal, and so are
`resident_kv_report` (the port's caches hold no position counters, so
its `kv_bytes_allocated` is the JAX one less those int32 leaves) and
`prefix_pool_nbytes` (likewise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ref_greedy
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import FinishReason, SamplingParams

V, MAX_LEN, DEPTH, SLOTS = 32, 64, 2, 2


@pytest.fixture(scope="module")
def llama_pair():
    jm = jax_tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=DEPTH)
    params = jm.init(jax.random.key(1), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    sd = llama_params_from_jax(jax.tree.map(np.asarray, params))
    return jm, {"params": params}, sd


def _wave():
    rng = np.random.RandomState(7)
    base = rng.randint(0, V, 20)
    sibling = np.concatenate([base[:12], rng.randint(0, V, 6)])
    other = rng.randint(0, V, 21)
    short = base[:5]
    # (prompt, new tokens) in submission order, three waves.
    return [[(base, 6), (other, 5)],
            [(base, 7), (sibling, 6), (short, 1)],
            [(other[:17], 4), (base, 3)]]


@pytest.mark.parametrize("pool_blocks", [None, 7, 0],
                         ids=["prefix_default", "prefix_evicting",
                              "prefix_off"])
def test_row_engine_token_exact_vs_jax_engine(llama_pair, pool_blocks):
    jm, variables, sd = llama_pair
    tm = tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=DEPTH, device="cpu")
    tm.load_state_dict(sd)
    kw = dict(max_slots=SLOTS, prefill_len=24, prefix_block_size=4,
              prefix_cache_blocks=pool_blocks)
    engines = {"jax": JaxServeEngine(jm, variables, paged=False,
                                     preempt_cap=0, **kw),
               "port": ServeEngine(tm, device="cpu", **kw)}
    assert not engines["port"].paged
    assert engines["port"].prefix_cache_enabled == (pool_blocks != 0)
    trace = {"jax": [], "port": []}
    reports = {"jax": [], "port": []}
    handles = {"jax": [], "port": []}
    for wave in _wave():
        for name, eng in engines.items():
            handles[name] += [eng.submit(p, n) for p, n in wave]
        while any(e.has_work for e in engines.values()):
            for name, eng in engines.items():
                emitted = eng.step()
                trace[name].append((emitted, eng.live_slots,
                                    eng.scheduler.depth))
                reports[name].append(eng.resident_kv_report())
    assert trace["port"] == trace["jax"]
    prompts = [p for wave in _wave() for p, _ in wave]
    news = [n for wave in _wave() for _, n in wave]
    for hp, hj, prompt, n in zip(handles["port"], handles["jax"], prompts,
                                 news):
        assert hp.tokens == hj.tokens
        assert hp.tokens == ref_greedy(jm, variables, prompt, n)
        assert hp.finish_reason is FinishReason.LENGTH
    port, jeng = engines["port"], engines["jax"]
    # The JAX trees' int32 position counters: one [S] vector per layer in
    # the slot cache, one scalar per layer in the pool.
    counters = DEPTH * SLOTS * 4
    pool_counters = DEPTH * 4 if pool_blocks != 0 else 0
    for ours, ref in zip(reports["port"], reports["jax"]):
        assert ours["tokens_resident"] == ref["tokens_resident"]
        assert ours["kv_bytes_used"] == ref["kv_bytes_used"]
        assert ours["kv_bytes_allocated"] == (
            ref["kv_bytes_allocated"] - counters - pool_counters)
    assert port.prefix_pool_nbytes == max(
        jeng.prefix_pool_nbytes - pool_counters, 0)
    assert port.blocks_shared == port.block_table_fill == 0
    ours, ref = port.metrics.snapshot(), jeng.metrics.snapshot()
    timed = ("ttft", "latency", "tokens_per_s")
    for key, val in ours.items():
        if not any(t in key for t in timed):
            assert val == ref[key], key
    if pool_blocks == 0:
        assert ours["prefix_lookups"] == 0
        assert port.metrics.copy_bytes_gathered == 0
    else:
        assert ours["prefix_hits"] >= 3
        assert port.metrics.copy_bytes_gathered == (
            ours["prefill_tokens_saved"] * port._kv_token_bytes)
        assert port.metrics.copy_bytes_donated > 0
    if pool_blocks == 7:
        assert ours["prefix_evictions"] > 0


def test_row_engine_sampled_request_stays_in_its_filter(llama_pair):
    """A ``top_k=1`` request equals the greedy stream beside a sampled
    one, and a seeded ``rng`` replays the sampled stream."""
    jm, variables, sd = llama_pair
    tm = tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=DEPTH, device="cpu")
    tm.load_state_dict(sd)
    prompt = (np.arange(10) * 3 + 2) % V
    streams = []
    for seed in (7, 7):
        eng = ServeEngine(tm, device="cpu", max_slots=2, prefill_len=16,
                          rng=torch.Generator().manual_seed(seed))
        top1 = eng.submit(prompt, 6, sampling=SamplingParams(
            temperature=0.9, top_k=1))
        hot = eng.submit(prompt, 6, sampling=SamplingParams(
            temperature=1.5, top_k=8))
        eng.run()
        streams.append(hot.tokens)
        assert top1.tokens == ref_greedy(jm, variables, prompt, 6)
        assert len(hot.tokens) == 6
    assert streams[0] == streams[1]


@pytest.mark.parametrize("kw,match", [
    (dict(prefix_cache_blocks=1), "must be >= 2"),
    (dict(prefix_block_size=16, prefix_cache_blocks=8),
     "leaves no cacheable block"),
    (dict(prefix_chunk=60), "prefix_chunk 60"),
    (dict(paged=True, prefix_cache_blocks=0), "block-pool machinery"),
])
def test_row_engine_config_errors_match_jax(llama_pair, kw, match):
    jm, variables, sd = llama_pair
    tm = tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=DEPTH, device="cpu")
    base = dict(max_slots=2, prefill_len=16)
    with pytest.raises(ValueError, match=match):
        JaxServeEngine(jm, variables, **base, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(tm, device="cpu", **base, **kw)
