"""The host KV tier of the port's serving engine
(`pddl_tpu_torch/serve/kvcache/hosttier.py`, `ServeEngine(host_tier=)`)
against the JAX package's on the CPU.

- `HostTierCache` unit behaviours (store, match, pin, evict, the full-budget
  backfill, the hole that ends a chain, the spec refusing a malformed
  payload) run on both packages' caches over the same operations — numpy
  payloads there, CPU torch tensors here — with byte-equal budgets and
  equal answers.
- The radix index's eviction offers its victims to the demotion hook;
  the degraded flush does not.
- Demote/promote token-exact in both modes (`tiny_gpt`) and on a tiny
  Llama, step for step the JAX engine's tokens and host-tier counters
  (spills, hits, promotions, tokens charged, bytes resident).
- A zero budget equal to no tier; the refusals in the JAX engine's words;
  degraded mode touching the tier in neither direction; the promotion's
  budget charge and `min_chain_blocks`; a fault storm at `host_promote`
  replaying token-exact with the JAX engine's injections.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock, ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.faults import FaultKind as JaxFaultKind
from pddl_tpu.serve.faults import FaultPlan as JaxFaultPlan
from pddl_tpu.serve.faults import FaultSpec as JaxFaultSpec
from pddl_tpu.serve.kvcache import HostTierCache as JaxHostTierCache
from pddl_tpu.serve.kvcache import HostTierConfig as JaxHostTierConfig
from pddl_tpu.serve.kvcache import RadixPrefixCache as JaxRadix
from pddl_tpu_torch.bridge import gpt_params_from_jax, llama_params_from_jax
from pddl_tpu_torch.models.gpt import tiny_gpt
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.serve import (
    FaultKind,
    FaultPlan,
    FaultSpec,
    HostTierCache,
    HostTierConfig,
    RadixPrefixCache,
    ServeEngine,
)
from pddl_tpu_torch.serve.request import Request, RequestHandle

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V, MAX_LEN, BS = 32, 64, 8
TIER_KEYS = ("host_tier_spills", "host_tier_hits", "host_tier_promotions",
             "host_tier_promote_tokens_charged", "host_tier_bytes_resident")


def _no_sleep(_):
    pass


@pytest.fixture(scope="module")
def gpt():
    jm = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_gpt(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, {"params": params}, tm


@pytest.fixture(scope="module")
def llama():
    jm = jax_tiny_llama(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(1), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_llama(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, {"params": params}, tm


def _prompts(n=4, length=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=length).astype(np.int32)
            for _ in range(n)]


def _kw(paged, **kw):
    """The JAX file's tier-testable engine: a TINY device pool (row: 7
    allocatable blocks; paged: floor + 1) so cycling a few 3-block prompts
    forces eviction, the demotion trigger."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_len", 32)
    kw.setdefault("prefix_block_size", BS)
    kw.setdefault("prefix_chunk", BS)
    kw.setdefault("prefix_cache_blocks",
                  2 * (MAX_LEN // BS) + 2 if paged else 8)
    return dict(kw, paged=paged)


def _pair(model, paged=False, host=1 << 24, jax_host=None, **kw):
    jm, jv, tm = model
    jkw, tkw = _kw(paged, **kw), _kw(paged, **kw)
    for key in ("fault_plan", "clock"):
        if key in kw:
            jkw[key], tkw[key] = kw[key]
    return (JaxServeEngine(jm, jv, host_tier=(host if jax_host is None
                                               else jax_host), **jkw),
            ServeEngine(tm, device="cpu", host_tier=host, **tkw))


def _serve_all(eng, prompts, n_new=4):
    outs = []
    for p in prompts:
        h = eng.submit(p, n_new)
        eng.run(max_steps=5000)
        assert h.done, h.state
        outs.append(list(h.tokens))
    return outs


def _tier_counters(eng):
    snap = eng.metrics.snapshot()
    return {k: snap[k] for k in TIER_KEYS}


# ------------------------------------------------------------ tier unit
def _payloads(val, shape=(1, 2, BS, 4)):
    """The same block payload for both caches: numpy for the JAX one,
    a CPU torch tensor for the port's."""
    k = np.full(shape, val, np.float32)
    return ({"k": k, "v": -k},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(-k)})


def _caches(budget_blocks, **kw):
    block_bytes = sum(a.nbytes for a in _payloads(1.0)[0].values())
    jspec = {"k": ((1, 2, BS, 4), np.dtype(np.float32)),
             "v": ((1, 2, BS, 4), np.dtype(np.float32))}
    tspec = {"k": ((1, 2, BS, 4), torch.float32),
             "v": ((1, 2, BS, 4), torch.float32)}
    return (JaxHostTierCache(BS, budget_blocks * block_bytes,
                             leaf_spec=jspec, **kw),
            HostTierCache(BS, budget_blocks * block_bytes, leaf_spec=tspec,
                          **kw)), block_bytes


def _state(tier):
    return (tier.bytes_resident, tier.blocks_resident, tier.spills,
            tier.evictions, tier.pins_outstanding)


def test_hosttier_store_match_pin_evict_equal_to_jax():
    tiers, block_bytes = _caches(3)
    toks = list(range(4 * BS))
    other = [100 + t for t in range(BS)]
    results = []
    for i, tier in enumerate(tiers):
        out = []
        for depth, val in ((3, 3.0), (2, 2.0), (1, 1.0)):
            out.append(tier.store(toks[:depth * BS], _payloads(val)[i]))
        out.append(_state(tier))
        out.append(tier.store(toks[:2 * BS], _payloads(9.0)[i]))
        tip = tier.match_from(toks, 0, 4)
        out.append(tip.depth)
        out.append([float(d["k"][0, 0, 0, 0])
                    for d in tier.chain_data(tip, 3)])
        out.append(tier.match_depth(toks, 1, 4))
        tip = tier.pin_chain(toks, 0, 3)
        out.append((tip.depth, tier.pins_outstanding))
        out.append(tier.store(other, _payloads(7.0)[i]))
        out.append(tier.match_depth(toks, 0, 3))
        tier.unpin(tip)
        out.append(tier.store(other, _payloads(7.0)[i]))
        out.append(_state(tier))
        bad = {"k": _payloads(1.0)[i]["k"]}
        out.append(tier.store([300 + t for t in range(BS)], bad))
        wrong = dict(_payloads(1.0)[i])
        wrong["k"] = (wrong["k"].astype(np.float64) if i == 0
                      else wrong["k"].double())
        out.append(tier.store([300 + t for t in range(BS)], wrong))
        results.append(out)
    assert results[0] == results[1]
    assert results[1][3] == (3 * block_bytes, 3, 3, 0, 0)
    assert results[1][:3] == [True, True, True]
    assert results[1][4] is False and results[1][7] == 2
    assert results[1][9] is False and results[1][11] is True
    assert results[1][-2:] == [False, False]


def test_hosttier_full_budget_backfill_equal_to_jax():
    tiers, block_bytes = _caches(1)
    toks = list(range(2 * BS))
    other = [100 + t for t in range(BS)]
    results = []
    for i, tier in enumerate(tiers):
        out = [tier.store(toks[:2 * BS], _payloads(2.0)[i]),
               tier.store(toks[:BS], _payloads(1.0)[i]), _state(tier)]
        tip = tier.match_from(toks, 0, 2)
        out.append((tip.depth, float(tip.data["k"][0, 0, 0, 0])))
        out.append(tier.store(other, _payloads(7.0)[i]))
        out.append(_state(tier))
        out.append(tier.match_depth(toks, 0, 2))
        results.append(out)
    assert results[0] == results[1]
    assert results[1][3] == (1, 1.0) and results[1][-1] == 0
    assert results[1][2][:2] == (block_bytes, 1)


def test_hosttier_hole_ends_promotable_chain_equal_to_jax():
    tiers, _ = _caches(64)
    toks = list(range(3 * BS))
    depths = []
    for i, tier in enumerate(tiers):
        assert tier.store(toks[:BS], _payloads(1.0)[i])
        assert tier.store(toks[:3 * BS], _payloads(3.0)[i])
        depths.append(tier.match_from(toks, 0, 3).depth)
    assert depths == [1, 1]


def test_radix_flush_bypasses_demotion_hook():
    """Allocation-pressure eviction offers the LRU victim to ``on_evict``;
    the degraded flush frees both stored blocks and offers nothing, in
    both packages."""
    results = []
    for cls in (JaxRadix, RadixPrefixCache):
        idx = cls(BS, 4)
        seen = []
        idx.on_evict = lambda victims, _i=idx, _s=seen: _s.extend(
            _i.chain_tokens(v) for v in victims)
        toks = list(range(3 * BS))
        ids = idx.allocate(3)
        idx.extend(idx.match(toks).node, toks, ids)
        idx.allocate(1)
        first = list(seen)
        seen.clear()
        freed = idx.flush_unpinned()
        results.append((first, freed, idx.blocks_live, list(seen),
                        idx.chain_depth(idx.match(toks).node)))
    assert results[0] == results[1]
    assert len(results[1][0]) == 1 and results[1][1:4] == (2, 1, [])


# ------------------------------------------------- engine token-exact
@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_demote_promote_token_exact_vs_jax(gpt, paged):
    """Cycling more chains than the device pool holds forces demotion;
    revisiting them forces promotion: every stream equals the JAX
    engine's and ``generate``'s, and so does every tier counter."""
    jeng, eng = _pair(gpt, paged=paged)
    prompts = _prompts(6)
    refs = [ref_greedy(gpt[0], gpt[1], p, 4) for p in prompts]
    for _ in range(3):
        assert _serve_all(jeng, prompts) == refs
        assert _serve_all(eng, prompts) == refs
        assert _tier_counters(eng) == _tier_counters(jeng)
    snap = eng.metrics.snapshot()
    assert snap["host_tier_spills"] > 0
    assert snap["host_tier_hits"] > 0
    assert snap["host_tier_promotions"] > 0
    assert snap["host_tier_promote_tokens_charged"] > 0
    assert eng.host_tier_bytes_resident == jeng.host_tier_bytes_resident > 0
    assert eng.host_tier_blocks_resident == jeng.host_tier_blocks_resident
    assert eng._host.pins_outstanding == 0


def test_llama_promotion_token_exact_vs_jax(llama):
    jeng, eng = _pair(llama)
    prompts = _prompts(4, seed=5)
    refs = [ref_greedy(llama[0], llama[1], p, 4) for p in prompts]
    for _ in range(2):
        assert _serve_all(eng, prompts) == refs
        assert _serve_all(jeng, prompts) == refs
    assert _tier_counters(eng) == _tier_counters(jeng)
    assert eng.metrics.host_tier_promotions > 0


def test_budget_zero_is_bit_identical_to_untiered(gpt):
    prompts = _prompts(4)
    for paged in (False, True):
        plain = ServeEngine(gpt[2], device="cpu", host_tier=None,
                            **_kw(paged))
        zero = ServeEngine(gpt[2], device="cpu",
                           host_tier=HostTierConfig(byte_budget=0),
                           **_kw(paged))
        assert not zero.host_tier_enabled
        assert zero._prefix.on_evict is None
        outs = [[_serve_all(e, prompts) for _ in range(2)]
                for e in (plain, zero)]
        assert outs[0] == outs[1]
        ours, ref = zero.metrics.snapshot(), plain.metrics.snapshot()
        for key, val in ours.items():
            if not any(t in key for t in ("ttft", "latency", "per_s")):
                assert val == ref[key], key


@pytest.mark.parametrize("case", ["prefix_off", "draft_model"])
def test_refusals_in_jax_words(gpt, case):
    jm, jv, tm = gpt
    if case == "prefix_off":
        kw, err = dict(max_slots=2, prefill_len=32,
                       prefix_cache_blocks=0), ValueError
        jkw, tkw = dict(kw), dict(kw)
    else:
        kw, err = dict(max_slots=2, prefill_len=32, paged=True, spec_k=2,
                       prefix_block_size=BS), NotImplementedError
        jd = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=1)
        dparams = {k: v for k, v in jv["params"].items() if k != "block1"}
        td = tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=1, device="cpu")
        jkw = dict(kw, spec_draft_model=jd,
                   spec_draft_variables={"params": dparams})
        tkw = dict(kw, spec_draft_model=td)
    errors = []
    for build in (lambda: JaxServeEngine(jm, jv, host_tier=1 << 20, **jkw),
                  lambda: ServeEngine(tm, device="cpu", host_tier=1 << 20,
                                      **tkw)):
        with pytest.raises(err) as info:
            build()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "prefix-cache machinery" in errors[0] or "draft" in errors[0]


def test_degraded_mode_touches_the_tier_in_neither_direction(gpt):
    """An injected OOM at the tick flips the engine degraded: the flush
    hard-frees (no spills) and admissions during the cool-down promote
    nothing — and the JAX engine agrees on every tier counter."""
    prompts = _prompts(6)
    results = []
    for name, eng in zip(("jax", "port"), _pair(
            gpt, clock=(FakeClock(), FakeClock()),
            backoff_sleep=_no_sleep, degraded_cooldown_s=100.0)):
        _serve_all(eng, prompts)
        _serve_all(eng, prompts)
        spills = eng.metrics.host_tier_spills
        assert spills > 0
        nbytes = eng.host_tier_bytes_resident
        plan_cls, spec_cls, kind = (
            (JaxFaultPlan, JaxFaultSpec, JaxFaultKind.OOM) if name == "jax"
            else (FaultPlan, FaultSpec, FaultKind.OOM))
        eng._faults = plan_cls(scheduled=[
            spec_cls(step=eng._step_idx, site="tick", kind=kind)])
        h = eng.submit(prompts[0], 4)
        for _ in range(5):
            eng.step()
            if eng.degraded:
                break
        assert eng.degraded
        assert eng.metrics.host_tier_spills == spills
        hits = eng.metrics.host_tier_hits
        h2 = eng.submit(prompts[1], 4)
        eng.run(max_steps=2000)
        assert h.done and h2.done
        assert eng.metrics.host_tier_hits == hits
        assert eng.host_tier_bytes_resident == nbytes
        results.append((_tier_counters(eng), h.tokens, h2.tokens))
    assert results[0] == results[1]


def test_promotion_budget_charge_equal_to_jax(gpt):
    """A host-tier chain charges ``promote_tokens_per_block`` a block
    instead of ``block_size`` prefill tokens, in the cost and on the
    counter, as in the JAX engine."""
    prompts = _prompts(4)
    target = prompts[0]
    got = []
    for eng, cfg_cls in zip(
            _pair(gpt, host=HostTierConfig(byte_budget=1 << 24,
                                           promote_tokens_per_block=3),
                  jax_host=JaxHostTierConfig(byte_budget=1 << 24,
                                             promote_tokens_per_block=3),
                  prefill_token_budget=64),
            (JaxHostTierConfig, HostTierConfig)):
        _serve_all(eng, prompts)

        def cost_of(p, _eng=eng):
            h = RequestHandle(Request(prompt=list(p), max_new_tokens=4),
                              arrival_s=0.0)
            return _eng._prefill_cost(h)

        cold = cost_of(np.asarray(
            np.random.default_rng(9).integers(0, V, 24), np.int32))
        cap = (24 - 1) // BS
        m = eng._prefix.match(target, max_blocks=cap).n_blocks
        h = eng._host.match_depth(target, m, cap - m)
        assert h > 0
        cost = cost_of(target)
        assert cost == 24 - (m + h) * BS + h * 3
        before = eng.metrics.host_tier_promote_tokens_charged
        handle = eng.submit(target, 4)
        eng.run(max_steps=2000)
        got.append((cold, m, h, cost,
                    eng.metrics.host_tier_promote_tokens_charged - before,
                    handle.tokens))
    assert got[0] == got[1]
    assert got[1][0] == 24 and got[1][4] == got[1][2] * 3


def test_min_chain_blocks_policy(gpt):
    """Chains shorter than ``min_chain_blocks`` are freed, not demoted."""
    eng = ServeEngine(gpt[2], device="cpu", host_tier=HostTierConfig(
        byte_budget=1 << 24, min_chain_blocks=3), **_kw(False))
    prompts = _prompts(4, length=16, seed=3)
    for _ in range(3):
        _serve_all(eng, prompts)
    assert eng.metrics.prefix_evictions > 0
    assert eng.metrics.host_tier_spills == 0


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_fault_storm_at_host_promote_lockstep_vs_jax(gpt, paged):
    """Seeded transients aimed at the promotion while chains cycle
    through the tier: the same injections as the JAX engine, every stream
    token-exact, no leaked host pin."""
    logs = {"jax": [], "port": []}
    plans = []
    for name, plan_cls in (("jax", JaxFaultPlan), ("port", FaultPlan)):
        plan = plan_cls(seed=7, transient_rate=1.0, sites=["host_promote"],
                        max_random_injections=4, sleep_fn=_no_sleep)
        plan.on_inject = lambda *a, _log=logs[name]: _log.append(a)
        plans.append(plan)
    jeng, eng = _pair(gpt, paged=paged, fault_plan=tuple(plans),
                      backoff_sleep=_no_sleep)
    # The paged pool (floor + 1) keeps 4 chains: 6 overflow it.
    prompts = _prompts(6 if paged else 4)
    refs = [ref_greedy(gpt[0], gpt[1], p, 4) for p in prompts]
    for _ in range(3):
        assert _serve_all(jeng, prompts) == refs
        assert _serve_all(eng, prompts) == refs
    assert logs["port"] == logs["jax"] and logs["port"]
    for key in ("retries", "retry_sites", "replays") + TIER_KEYS:
        assert eng.metrics.snapshot()[key] == jeng.metrics.snapshot()[key]
    assert eng._host.pins_outstanding == 0
