"""The port's speculative serving (`ServeEngine(spec_k > 0)`) against the
JAX engine on the CPU, from the same bridged `tiny_llama` weights: the
resident-row and paged engines with the n-gram drafter, and the paged
engine with a draft model (the target's embedding, first block, final
norm and head as a depth-1 Llama: the self-draft `chip_smoke.py` uses).

- A wave of repetitive and random prompts (shared prefixes, a queue, a
  stream whose window reaches past `max_len`, a one-token request): step
  for step the same tokens, live slots and queue depth; every stream
  equals `ref_greedy`; the clock-free snapshot entries (the `spec_*`
  counters and the acceptance rate included) and each handle's
  `spec_drafted` / `spec_accepted` are equal; drafts were accepted.
- EOS inside a verify window stops the stream there, in both modes.
- Sampled rows never speculate (their cap is 0): a `top_k=1` row equals
  greedy, a sampled row stays in its filter, one seed gives one stream.
- The configuration errors of the JAX engine, in its words, and the
  options still refused, each naming its ROADMAP.md item (tenancy, now
  ported, is held against the JAX engine there instead; int8 weights
  through `param_transform` and `spec_draft_variables`, ported too, are
  held to what they do).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ref_greedy
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.request import SamplingParams as JaxSamplingParams
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.gpt import filtered_logits, generate
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.ops.quant import dequantize, install_params, quantize_int8
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import FinishReason, SamplingParams
from pddl_tpu_torch.serve.tenant import TenantConfig

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V, MAX_LEN, SLOTS, K = 32, 64, 3, 4
ENGINE_KW = dict(max_slots=SLOTS, prefill_len=24, prefix_block_size=4,
                 spec_k=K)


def _port(params, depth):
    tm = tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=depth, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return tm


@pytest.fixture(scope="module")
def models():
    """The JAX target and its params, the JAX self-draft and its params,
    and the port's twins."""
    jm = jax_tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=2)
    params = jm.init(jax.random.key(1), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    jd = jax_tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=1)
    dparams = {k: v for k, v in params.items() if k != "block1"}
    return dict(jm=jm, jv={"params": params}, jd=jd,
                jdv={"params": dparams}, tm=_port(params, 2),
                td=_port(dparams, 1))


def _engines(models, mode, **kw):
    """A JAX engine and the port's, with ``mode`` one of ``row``,
    ``paged`` (n-gram drafts) or ``draft`` (paged, the draft model)."""
    jkw, tkw = dict(ENGINE_KW, **kw), dict(ENGINE_KW, **kw)
    if mode != "row":
        jkw["paged"] = tkw["paged"] = True
    if mode == "draft":
        jkw.update(spec_draft_model=models["jd"],
                   spec_draft_variables=models["jdv"])
        tkw.update(spec_draft_model=models["td"])
    return {"jax": JaxServeEngine(models["jm"], models["jv"], preempt_cap=0,
                                  **jkw),
            "port": ServeEngine(models["tm"], device="cpu", **tkw)}


def _dense_greedy(model, q, prompt, n):
    """``generate`` over the dense dequantized weights of ``q``."""
    dense = install_params(copy.deepcopy(model), dequantize(q))
    return generate(dense, prompt[None], n)[0, len(prompt):].tolist()


def _loop(motif_seed, n):
    rng = np.random.RandomState(motif_seed)
    return np.resize(rng.randint(0, V, rng.randint(3, 6)), n)


def _wave():
    rng = np.random.RandomState(7)
    loop = _loop(1, 20)
    sibling = np.concatenate([loop[:12], _loop(2, 8)])
    rand = rng.randint(0, V, 17)
    # (prompt, new tokens) per wave; the first stream ends at max_len, its
    # last windows reaching past the cache.
    return [[(loop, MAX_LEN - 20), (rand, 12), (_loop(3, 9), 1)],
            [(sibling, 15), (loop, 9), (rng.randint(0, V, 6), 30),
             (_loop(4, 16), 20)]]


def _run(engines, waves):
    """Submit each wave to every engine (a third entry of a request is
    its sampling keywords, made into each package's ``SamplingParams``),
    then step them in lockstep until both drain."""
    trace = {name: [] for name in engines}
    handles = {name: [] for name in engines}
    params_cls = {"jax": JaxSamplingParams, "port": SamplingParams}
    for wave in waves:
        for name, eng in engines.items():
            for prompt, n, *sampling in wave:
                kw = ({"sampling": params_cls[name](**sampling[0])}
                      if sampling else {})
                handles[name].append(eng.submit(prompt, n, **kw))
        while any(e.has_work for e in engines.values()):
            for name, eng in engines.items():
                emitted = eng.step()
                trace[name].append((emitted, eng.live_slots,
                                    eng.scheduler.depth))
    return trace, handles


def _assert_snapshots_equal(port, jeng):
    ours, ref = port.metrics.snapshot(), jeng.metrics.snapshot()
    timed = ("ttft", "latency", "tokens_per_s")
    for key, val in ours.items():
        if not any(t in key for t in timed):
            assert val == ref[key], key
    assert "spec_acceptance_rate" in port.metrics.summary()


@pytest.mark.parametrize("mode", ["row", "paged", "draft"])
def test_spec_engine_token_exact_vs_jax_engine(models, mode):
    engines = _engines(models, mode)
    port = engines["port"]
    assert port.spec_enabled and port.spec_k == K
    assert port.spec_draft_model_enabled == (mode == "draft")
    assert port.paged == (mode != "row")
    deepest, verify = [], port._verify

    def spy(*args):  # the deepest slot's position at each verify
        deepest.append(int(port._positions.max()))
        return verify(*args)
    port._verify = spy
    trace, handles = _run(engines, _wave())
    assert max(deepest) + K >= MAX_LEN  # a window ran past the cache
    assert trace["port"] == trace["jax"]
    waves = [r for w in _wave() for r in w]
    for hp, hj, (prompt, n) in zip(handles["port"], handles["jax"], waves):
        assert hp.tokens == hj.tokens
        assert hp.tokens == ref_greedy(models["jm"], models["jv"], prompt, n)
        assert hp.finish_reason is FinishReason.LENGTH
        assert (hp.spec_drafted, hp.spec_accepted) == (hj.spec_drafted,
                                                       hj.spec_accepted)
    assert len(handles["port"][0].tokens) + 20 == MAX_LEN
    _assert_snapshots_equal(port, engines["jax"])
    snap = port.metrics.snapshot()
    assert snap["spec_ticks"] > 0
    assert 0 < snap["spec_accepted_tokens"] <= snap["spec_drafted_tokens"]
    # Fewer decode steps than tokens: the windows really accepted drafts.
    assert len(trace["port"]) < snap["tokens_emitted"] - len(waves)


@pytest.mark.parametrize("mode", ["row", "draft"])
def test_eos_inside_a_window_stops_the_stream(models, mode):
    """The eos token first appears as the 6th or a later greedy token of
    a looping stream, so it arrives inside an accepted window; the
    stream ends there, eos included, step for step with the JAX
    engine."""
    prompt = _loop(5, 18)
    ref = ref_greedy(models["jm"], models["jv"], prompt, 30)
    cut = next(i for i, t in enumerate(ref) if i >= 5 and ref.index(t) == i)
    eos = ref[cut]
    cut += 1
    engines = _engines(models, mode, eos_token=eos)
    trace, handles = _run(engines, [[(prompt, 30), (_loop(6, 10), 8)]])
    assert trace["port"] == trace["jax"]
    hp, hj = handles["port"][0], handles["jax"][0]
    assert hp.tokens == hj.tokens == ref[:cut]
    assert hp.finish_reason is FinishReason.EOS
    assert hp.spec_accepted == hj.spec_accepted
    # Fewer windows than tokens after the first: eos came out of a window
    # that had accepted drafts.
    assert 0 < hp.spec_drafted // K < cut - 1
    _assert_snapshots_equal(engines["port"], engines["jax"])


@pytest.mark.parametrize("mode", ["row", "paged"])
def test_sampled_rows_never_speculate(models, mode):
    """Beside two greedy streams: a ``top_k=1`` row equals greedy with
    nothing drafted, and a hot row's tokens lie in its filter; the
    greedy rows and every spec counter match the JAX engine's; one seed
    replays the hot stream."""
    prompt = _loop(8, 12)
    wave = [(prompt, 14), (prompt, 10, dict(temperature=0.9, top_k=1)),
            (_loop(9, 14), 12, dict(temperature=1.3, top_k=5)),
            (_loop(10, 11), 16)]
    streams = []
    for seed in (3, 3):
        engines = _engines(models, mode)
        engines["port"]._rng = torch.Generator().manual_seed(seed)
        trace, handles = _run(engines, [wave])
        hp, hj = handles["port"], handles["jax"]
        assert trace["port"] == trace["jax"]
        for i in (0, 1, 3):
            assert hp[i].tokens == hj[i].tokens == ref_greedy(
                models["jm"], models["jv"], wave[i][0], wave[i][1])
        for i in (1, 2):
            assert hp[i].spec_drafted == hj[i].spec_drafted == 0
        assert hp[0].spec_drafted > 0
        _assert_snapshots_equal(engines["port"], engines["jax"])
        hot = hp[2].tokens
        assert len(hot) == 12
        seq = list(wave[2][0])
        for tok in hot:  # each token inside its step's top-5 filter
            with torch.no_grad():
                logits = models["tm"](torch.tensor([seq]))[0, -1]
            keep = torch.isfinite(filtered_logits(logits[None],
                                                  temperature=1.3, top_k=5))
            assert keep[0, tok]
            seq.append(tok)
        streams.append(hot)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("kw,err,match", [
    (dict(spec_k=-1), ValueError, "spec_k must be >= 0"),
    (dict(spec_k=2, spec_ngram=0), ValueError, "spec_ngram must be >= 1"),
    (dict(draft=True), ValueError, "needs spec_k >= 1"),
    (dict(spec_k=2, draft=True, paged=False), ValueError, "pass paged=True"),
    (dict(spec_k=2, draft="vocab"), ValueError, "draft model vocab 40"),
    (dict(spec_k=2, draft="short"), ValueError, "draft model max_len 32"),
    (dict(spec_k=2, draft="ring"), NotImplementedError, "rolling ring"),
])
def test_spec_config_errors_match_jax(models, kw, err, match):
    kw = dict(kw)
    draft = kw.pop("draft", None)
    base = dict(max_slots=2, prefill_len=16, paged=True)
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    if draft is not None:
        dkw = {"vocab": dict(vocab_size=40), "short": dict(max_len=32),
               "ring": dict(max_len=512, sliding_window=8)}.get(draft, {})
        dkw = dict(dict(vocab_size=V, max_len=MAX_LEN, depth=1), **dkw)
        jd = jax_tiny_llama(**dkw)
        jkw.update(spec_draft_model=jd, spec_draft_variables={
            "params": jd.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                              train=False)["params"]})
        tkw.update(spec_draft_model=tiny_llama(device="cpu", **dkw))
    with pytest.raises(err, match=match):
        JaxServeEngine(models["jm"], models["jv"], preempt_cap=0, **jkw)
    with pytest.raises(err, match=match):
        ServeEngine(models["tm"], device="cpu", **tkw)


@pytest.mark.parametrize("what", [
    "tenant", "constraint", "fault_plan", "prefill_slice_tokens", "drain",
    "restore", "param_transform", "spec_draft_variables"])
def test_still_refused_options_name_their_item(models, what):
    """Every option a speculative engine once refused is ported now, each
    held to what it does. Tenancy: a speculative engine takes a
    ``TenantConfig`` (grammar-constrained speculation), and without one
    ``submit(constraint=...)`` raises the JAX engine's ``ValueError``, in
    both packages. ``param_transform`` (int8 serving),
    ``spec_draft_variables``, ``fault_plan``, sliced prefill and
    drain/restore are checked below."""
    kw = dict(ENGINE_KW, paged=True)
    if what in ("tenant", "constraint"):
        jeng = JaxServeEngine(models["jm"], models["jv"], preempt_cap=0,
                              tenant=JaxTenantConfig() if what == "tenant"
                              else None, **kw)
        eng = ServeEngine(models["tm"], device="cpu",
                          tenant=TenantConfig() if what == "tenant"
                          else None, **kw)
        if what == "tenant":
            assert eng.tenant_enabled and eng.spec_enabled
            assert jeng.tenant_enabled and jeng.spec_enabled
            return
        errors = []
        for engine in (jeng, eng):
            with pytest.raises(ValueError,
                               match="need a tenant-enabled engine") as info:
                engine.submit([1, 2], 2,
                              constraint={"kind": "regex", "pattern": "1"})
            errors.append(str(info.value))
        assert errors[0] == errors[1]
        return
    if what == "param_transform":
        # Ported (int8 serving): it transforms the int8 variables passed
        # with it, in a speculative engine as in the JAX one.
        q = quantize_int8(models["tm"], min_elems=128)
        eng = ServeEngine(copy.deepcopy(models["tm"]), {"params": q},
                          device="cpu", param_transform=dequantize, **kw)
        handle = eng.submit(_loop(1, 12), 6)
        eng.run(max_steps=50)
        assert handle.tokens == _dense_greedy(models["tm"], q,
                                              _loop(1, 12), 6)
        return
    if what == "spec_draft_variables":
        # Ported: a dense tree loads into the draft model; a tree that
        # is not the draft's raises, as the JAX engine cannot apply it.
        draft = copy.deepcopy(models["td"])
        eng = ServeEngine(models["tm"], device="cpu", spec_draft_model=draft,
                          spec_draft_variables={
                              "params": models["td"].state_dict()}, **kw)
        assert eng.spec_draft_model_enabled
        with pytest.raises(ValueError, match="do not match"):
            ServeEngine(models["tm"], device="cpu", spec_draft_model=draft,
                        spec_draft_variables={"params": {}}, **kw)
        return
    if what == "fault_plan":
        # Ported: a verify exhausted past its retries replays every live
        # stream, re-fed spec_k + 1 tokens a window, token-exact.
        from pddl_tpu_torch.serve.faults import (FaultKind, FaultPlan,
                                                 FaultSpec)
        streams = []
        for plan in (None, FaultPlan(scheduled=[
                FaultSpec(3, "verify", FaultKind.TRANSIENT, 3)])):
            eng = ServeEngine(models["tm"], device="cpu", fault_plan=plan,
                              max_retries=1, backoff_sleep=lambda s: None,
                              **kw)
            handles = [eng.submit(_loop(i, 12), 16) for i in range(2)]
            eng.run(max_steps=100)
            streams.append([h.tokens for h in handles])
        assert streams[0] == streams[1]
        assert eng.metrics.replays == 2 and eng.metrics.retries == 1
        return
    prompts = [_loop(i, 12 + 5 * i) for i in range(3)]
    whole = ServeEngine(models["tm"], device="cpu", **kw)
    want = [whole.submit(p, 16) for p in prompts]
    whole.run(max_steps=100)
    if what == "prefill_slice_tokens":
        # Ported: a speculative engine prefills at most 4 prompt tokens
        # a step, ticking between the slices, and emits the same streams.
        eng = ServeEngine(models["tm"], device="cpu",
                          prefill_slice_tokens=4, **kw)
        handles = [eng.submit(p, 16) for p in prompts]
        parked = 0
        while eng.has_work:
            eng.step()
            parked += eng._slice is not None
        assert parked >= 3
        assert [h.tokens for h in handles] == [h.tokens for h in want]
        return
    # Ported: a drain mid-stream snapshots the draft accounting (v5), and
    # the restore resumes every stream token-exactly in a fresh
    # speculative engine.
    eng = ServeEngine(models["tm"], device="cpu", **kw)
    for p in prompts:
        eng.submit(p, 16)
    for _ in range(2):
        eng.step()
    snap = eng.drain()
    assert eng.drained and not eng.has_work and eng.step() == 0
    if what == "drain":
        assert snap["version"] == 5 and snap["spec_k"] == K
        assert sum(e["spec"]["drafted"] for e in snap["requests"]) \
            == eng.metrics.spec_drafted_tokens
        with pytest.raises(RuntimeError, match="drained"):
            eng.submit(prompts[0], 2)
        return
    fresh = ServeEngine(models["tm"], device="cpu", **kw)
    restored = fresh.restore(snap)
    fresh.run(max_steps=100)
    assert [h.tokens for h in restored] == [h.tokens for h in want]
