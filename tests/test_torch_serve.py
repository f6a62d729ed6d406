"""The port's serving layer (`pddl_tpu_torch/serve/`) against the JAX one
on the CPU.

- `SLOScheduler` pops in the same order under a scripted workload
  (priorities, deadlines, aging, cancellation, a prefill budget);
- `RadixPrefixCache` hands out the same block ids and evicts the same
  blocks under a scripted sequence;
- `batched_filtered_logits` is exactly equal;
- the port's `ServeEngine(paged=True, device="cpu")` emits streams
  token-exact with JAX `ServeEngine(paged=True)` and with `ref_greedy`
  on the cold / full-hit / partial-hit workload of
  `tests/test_serve_paged.py`, step for step, with equal `blocks_shared`
  and `tokens_emitted`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock, ref_greedy
from pddl_tpu.models.gpt import batched_filtered_logits as jax_bfl
from pddl_tpu.models.gpt import filtered_logits as jax_filtered_logits
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.obs.ring import TelemetryRing as JaxRing
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.kvcache import RadixPrefixCache as JaxRadix
from pddl_tpu.serve.request import Priority as JaxPriority
from pddl_tpu.serve.request import Request as JaxRequest
from pddl_tpu.serve.request import RequestHandle as JaxHandle
from pddl_tpu.serve.scheduler import SLOScheduler as JaxScheduler
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.gpt import (
    batched_filtered_logits,
    filtered_logits,
    sample_logits_batched,
)
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.obs.ring import TelemetryRing
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.kvcache import RadixPrefixCache
from pddl_tpu_torch.serve.request import (
    Priority,
    Request,
    RequestHandle,
    SamplingParams,
)
from pddl_tpu_torch.serve.scheduler import SLOScheduler


def _pop_trace(sched_cls, req_cls, handle_cls, prio):
    """Submit a scripted mix, then admit under a moving fake clock;
    returns the popped request numbers per admit call."""
    clock = FakeClock(0.0)
    sched = sched_cls(max_queue_depth=16, prefill_token_budget=12,
                      aging_s=10.0)
    spec = [("best_effort", None, 3), ("batch", 5.0, 4), ("interactive", None, 6),
            ("batch", 2.0, 2), ("interactive", 1.0, 5), ("best_effort", None, 1),
            ("batch", None, 7), ("interactive", None, 2)]
    handles = []
    for i, (p, deadline, plen) in enumerate(spec):
        clock.now = 0.1 * i
        h = handle_cls(req_cls(prompt=[i] * plen, max_new_tokens=1,
                               deadline_s=deadline, priority=prio(p)),
                       arrival_s=clock())
        sched.submit(h)
        handles.append(h)
    handles[5].cancel()
    trace = []
    for now in (0.5, 3.0, 12.0, 25.0, 40.0):
        clock.now = now
        popped = sched.admit(2, now_fn=clock)
        trace.append([handles.index(h) for h in popped])
    states = [h.state.value for h in handles]
    return trace, states


def test_scheduler_pop_order_matches_jax():
    ours = _pop_trace(SLOScheduler, Request, RequestHandle, Priority)
    ref = _pop_trace(JaxScheduler, JaxRequest, JaxHandle, JaxPriority)
    assert ours == ref
    assert sum(len(t) for t in ours[0]) > 0


def _radix_trace(cls):
    """A scripted allocate / extend / pin / match / evict sequence."""
    rc = cls(2, 8)  # block_size 2, 7 allocatable blocks
    out = []
    a = list(range(10))
    ids = rc.allocate(3)
    tip = rc.extend(rc.match(a, max_blocks=0).node, a[:6], ids)
    rc.pin(tip)
    b = a[:4] + [90, 91, 92, 93]
    m = rc.match(b)
    out.append(("match", m.block_ids))
    ids_b = rc.allocate(2)
    tip_b = rc.extend(m.node, b[4:8], ids_b)
    out.append(("alloc", ids, ids_b, rc.chain_ids(tip_b)))
    rc.unpin(tip)
    c = [50, 51, 52, 53, 54, 55]
    ids_c = rc.allocate(5)  # evicts unpinned LRU leaves
    out.append(("evict", ids_c, rc.evictions, rc.blocks_free,
                rc.blocks_live))
    rc.release(ids_c[:2])
    node, depth = rc.descend(rc.match(c, max_blocks=0).node, c, 0)
    out.append(("descend", depth, rc.match(a).block_ids,
                rc.match(b).block_ids))
    out.append(("alloc2", rc.allocate(4), rc.evictions, rc.blocks_free))
    return out


def test_radix_block_ids_and_evictions_match_jax():
    ours, ref = _radix_trace(RadixPrefixCache), _radix_trace(JaxRadix)
    assert ours == ref
    assert ours[2][2] > 0  # the sequence really evicted


@pytest.mark.parametrize("n_records", [0, 3, 12])
def test_telemetry_ring_matches_jax(n_records):
    """Same records in, same window, newest record and summary out:
    empty, partly filled and wrapped."""
    rings = (TelemetryRing(5), JaxRing(5))
    for i in range(n_records):
        for ring in rings:
            ring.append({"step": i, "t_s": 0.5 * i, "queue_depth": i % 3,
                         "live_slots": i % 4, "tokens": i % 4 + 1,
                         "tick_wall_s": 0.01 * ((7 * i) % 5)})
    ours, ref = rings
    assert (len(ours), ours.total_appended) == (len(ref), ref.total_appended)
    assert ours.snapshot() == ref.snapshot()
    assert ours.last() == ref.last()
    # The summaries are equal, the retry, degraded and per-site wall-time
    # gauges included.
    assert ours.summary() == ref.summary()


def test_batched_filtered_logits_matches_jax_exactly():
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 40).astype(np.float32) * 3
    logits[1, 7] = logits[1, 9]  # a tie at the top-k boundary
    temps = np.array([0.0, 0.7, 1.3, 2.0, 1.0], np.float32)
    top_ks = np.array([0, 5, 1, 40, 3], np.int32)
    top_ps = np.array([2.0, 0.9, 0.5, 1.0, 0.3], np.float32)
    ref = jax_bfl(jnp.asarray(logits), temperature=temps, top_k=top_ks,
                  top_p=top_ps)
    got = batched_filtered_logits(torch.tensor(logits), temperature=temps,
                                  top_k=top_ks, top_p=top_ps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, None, None), (1.3, 5, None), (1.0, None, 0.5), (0.5, 3, 0.9)])
def test_filtered_logits_matches_jax_exactly(temperature, top_k, top_p):
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 40).astype(np.float32) * 3
    logits[0, 4] = logits[0, 11]  # a tie inside the kept set
    ref = jax_filtered_logits(jnp.asarray(logits), temperature=temperature,
                              top_k=top_k, top_p=top_p)
    got = filtered_logits(torch.tensor(logits), temperature=temperature,
                          top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_logits_batched_draws_from_the_filtered_set():
    """Greedy rows take the argmax, ``top_k=1`` rows too; a sampled row
    draws only tokens its filter keeps, and one seed gives one stream
    (the draw comes from the ``torch.Generator``, so it is not JAX's)."""
    rng = np.random.RandomState(2)
    logits = torch.tensor(rng.randn(4, 50).astype(np.float32) * 2)
    temps = np.float32([0.0, 1.0, 1.5, 0.8])
    top_ks = np.int32([0, 1, 4, 0])
    top_ps = np.float32([2.0, 2.0, 2.0, 0.6])
    keep = torch.isfinite(batched_filtered_logits(
        logits, temperature=temps, top_k=top_ks, top_p=top_ps))
    draws = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(seed)
        draws.append([sample_logits_batched(
            gen, logits, temperature=temps, top_k=top_ks,
            top_p=top_ps).tolist() for _ in range(30)])
    assert draws[0] == draws[1] and draws[0] != draws[2]
    argmax = logits.argmax(-1).tolist()
    for row in draws[0] + draws[2]:
        assert row[0] == argmax[0] and row[1] == argmax[1]
        assert keep[2, row[2]] and keep[3, row[3]]
    assert len({row[2] for row in draws[0]}) > 1  # row 2 really samples


@pytest.fixture(scope="module")
def llama_pair():
    jm = jax_tiny_llama(vocab_size=32, max_len=64)
    params = jm.init(jax.random.key(1), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    sd = llama_params_from_jax(jax.tree.map(np.asarray, params))
    return jm, {"params": params}, sd


def test_paged_engine_token_exact_vs_jax_engine(llama_pair):
    jm, variables, sd = llama_pair
    tm = tiny_llama(vocab_size=32, max_len=64, device="cpu")
    tm.load_state_dict(sd)
    jeng = JaxServeEngine(jm, variables, paged=True, max_slots=2,
                          prefill_len=16, preempt_cap=0)
    teng = ServeEngine(tm, device="cpu", paged=True, max_slots=2,
                       prefill_len=16)
    base = (np.arange(12) * 5 + 1) % 32
    sibling = np.concatenate([base[:8], (np.arange(6) + 17) % 32])
    trace = {"jax": [], "port": []}

    def run(engines):
        while any(e.has_work for e in engines.values()):
            for name, eng in engines.items():
                emitted = eng.step()
                trace[name].append((emitted, eng.blocks_shared,
                                    eng.metrics.blocks_shared))

    engines = {"jax": jeng, "port": teng}
    cold = {n: e.submit(base, 6) for n, e in engines.items()}
    run(engines)
    hit = {n: e.submit(base, 6) for n, e in engines.items()}
    part = {n: e.submit(sibling, 6) for n, e in engines.items()}
    run(engines)
    for handles, prompt in ((cold, base), (hit, base), (part, sibling)):
        assert handles["port"].tokens == handles["jax"].tokens
        assert handles["port"].tokens == ref_greedy(jm, variables, prompt, 6)
    assert trace["port"] == trace["jax"]
    assert max(s for _, s, _ in trace["port"]) > 0  # blocks really shared
    for key in ("tokens_emitted", "prefix_hits", "prefill_tokens_saved",
                "copy_bytes_avoided", "requests_finished"):
        assert getattr(teng.metrics, key) == getattr(jeng.metrics, key), key
    # Every clock-free entry of the port's snapshot equals the JAX one.
    ours, ref = teng.metrics.snapshot(), jeng.metrics.snapshot()
    timed = ("ttft", "latency", "tokens_per_s")
    for key, val in ours.items():
        if not any(t in key for t in timed):
            assert val == ref[key], key
    assert "tokens_emitted" in teng.metrics.summary()


def test_paged_engine_sampled_request_stays_in_its_filter(llama_pair):
    """A sampled request through the port's engine: ``top_k=1`` streams
    equal the greedy stream, and a seeded ``rng`` replays a sampled
    stream exactly."""
    jm, variables, sd = llama_pair
    tm = tiny_llama(vocab_size=32, max_len=64, device="cpu")
    tm.load_state_dict(sd)
    prompt = (np.arange(10) * 3 + 2) % 32
    streams = []
    for seed in (7, 7):
        eng = ServeEngine(tm, device="cpu", paged=True, max_slots=2,
                          prefill_len=16,
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
