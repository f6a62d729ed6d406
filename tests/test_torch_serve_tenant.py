"""The port's multi-tenant serving (`ServeEngine(tenant=TenantConfig(...))`)
against the JAX tenant engine on the CPU, from the same bridged
`tiny_llama` weights (vocabulary 32, the grammar vocabulary `VOCAB32` of
`tests/test_serve_tenant.py`), in both engine modes.

- The mixed batch (base, three adapters, a constraint, an adapter with a
  constraint): step for step the same tokens, live slots and queue depth
  as the JAX engine; base streams equal `ref_greedy`, adapted ones
  `generate()` over the merged head (`merge_lora_into_head`) in both
  packages; constrained streams finish GRAMMAR inside their grammar; the
  clock-free snapshot entries (the tenant counters and
  `requests_by_adapter`) are equal.
- A slot with no adapter and no constraint gives logits bitwise equal to
  the `tenant=None` engine's (f32), at admission and at every tick,
  beside adapted and constrained slots.
- A JSON-schema stream finishes GRAMMAR with a parseable document, as in
  the JAX engine; eos closes an accepting state with `FinishReason.EOS`.
- Pool churn at the floor (`max_slots + 1` rows): the same evictions,
  loads and hits as the JAX engine, every stream merged-exact.
- The cold-load charge of `adapter_load_tokens` defers an admission under
  a prefill budget exactly as in the JAX engine.
- `submit` and construction errors: the JAX engine's type and words.
- `spec_k=3` with constraints and adapters (row, paged, a draft model):
  step for step the JAX engine's tokens and spec counters.
- Cancels and expiries release every adapter pin, in both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu_torch.serve.engine as engine_mod
from conftest import FakeClock, ref_greedy
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.ops.lora import merge_lora_into_head as jax_merge
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.request import SamplingParams as JaxSamplingParams
from pddl_tpu.serve.tenant import AdapterRegistry as JaxRegistry
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.gpt import generate
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.ops.lora import merge_lora_into_head
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.request import (
    FinishReason,
    RequestState,
    SamplingParams,
)
from pddl_tpu_torch.serve.tenant import (
    AdapterRegistry,
    TenantConfig,
    compile_constraint,
)

V, MAX_LEN = 32, 64
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))
NAMES = ("acme", "globex", "initech")
DIGITS3 = {"kind": "regex", "pattern": "[0-9][0-9][0-9]"}
MODES = ["row", "paged"]


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_llama(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(1), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_llama(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    jd = jax_tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=1)
    dparams = {k: v for k, v in params.items() if k != "block1"}
    td = tiny_llama(vocab_size=V, max_len=MAX_LEN, depth=1, device="cpu")
    td.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, dparams)))
    return dict(jm=jm, jv={"params": params}, tm=tm, jd=jd,
                jdv={"params": dparams}, td=td)


def _registries(names=NAMES, seed0=100, rank=4, scale=0.1):
    regs = {"jax": JaxRegistry(32, V, rank=rank),
            "port": AdapterRegistry(32, V, rank=rank)}
    for reg in regs.values():
        for i, name in enumerate(names):
            reg.register_random(name, seed=seed0 + i, scale=scale)
    return regs


def _engines(models, mode="row", regs=None, tenant_kw=None, **kw):
    """A JAX tenant engine and the port's, the same knobs."""
    regs = regs or _registries()
    tenant_kw = dict(dict(token_strings=VOCAB32), **(tenant_kw or {}))
    draft = kw.pop("draft", False)
    kw = dict(dict(max_slots=3, prefill_len=16, prefix_block_size=4,
                   paged=mode != "row"), **kw)
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        jkw.update(spec_draft_model=models["jd"],
                   spec_draft_variables=models["jdv"])
        tkw["spec_draft_model"] = models["td"]
    return {"jax": JaxServeEngine(
                models["jm"], models["jv"], preempt_cap=0,
                tenant=JaxTenantConfig(registry=regs["jax"], **tenant_kw),
                **jkw),
            "port": ServeEngine(
                models["tm"], device="cpu",
                tenant=TenantConfig(registry=regs["port"], **tenant_kw),
                **tkw)}


def _run(engines, wave, max_steps=400):
    """Submit the wave (prompt, new, submit keywords) to every engine and
    step them in lockstep; returns the step traces and the handles."""
    trace = {name: [] for name in engines}
    handles = {name: [] for name in engines}
    for name, eng in engines.items():
        for prompt, n, kw in wave:
            kw = dict(kw)
            if "sampling" in kw:
                cls = JaxSamplingParams if name == "jax" else SamplingParams
                kw["sampling"] = cls(**kw["sampling"])
            handles[name].append(eng.submit(prompt, n, **kw))
    for _ in range(max_steps):
        if not any(e.has_work for e in engines.values()):
            break
        for name, eng in engines.items():
            trace[name].append((eng.step(), eng.live_slots,
                                eng.scheduler.depth))
    return trace, handles


def _assert_snapshots_equal(port, jeng):
    ours, ref = port.metrics.snapshot(), jeng.metrics.snapshot()
    for key, val in ours.items():
        if not any(t in key for t in ("ttft", "latency", "tokens_per_s")):
            assert val == ref[key], key


def _merged_greedy(models, reg, name, prompt, n):
    ad = reg.get(name)
    out = generate(merge_lora_into_head(models["tm"], ad.a, ad.b),
                   torch.tensor(np.asarray(prompt)[None]), n)
    return out[0, len(prompt):].tolist()


def _base(k):
    return (np.arange(11) * 3 + 2 + k) % V


@pytest.mark.parametrize("mode", MODES)
def test_mixed_batch_token_exact_vs_jax_and_merged_head(models, mode):
    regs = _registries()
    engines = _engines(models, mode, regs=regs, max_slots=6)
    port = engines["port"]
    assert port.tenant_enabled and port.adapter_registry is regs["port"]
    both = {"kind": "regex", "pattern": "[0-9][0-9][0-9][0-9]"}
    wave = [(_base(0), 6, {}), (_base(0), 6, dict(adapter="acme")),
            (_base(3), 6, dict(adapter="globex")),
            (_base(7), 6, dict(adapter="initech")),
            (_base(0), 8, dict(constraint=DIGITS3)),
            (_base(0), 8, dict(adapter="acme", constraint=both))]
    trace, handles = _run(engines, wave)
    assert trace["port"] == trace["jax"]
    assert trace["port"][0][1] == 6  # all six shared the first tick
    hp, hj = handles["port"], handles["jax"]
    for a, b in zip(hp, hj):
        assert a.tokens == b.tokens
        assert a.finish_reason.value == b.finish_reason.value
    assert hp[0].tokens == ref_greedy(models["jm"], models["jv"], _base(0), 6)
    for i, (prompt, n, kw) in enumerate(wave[1:4], 1):
        ad = regs["jax"].get(kw["adapter"])
        jm = {"params": jax_merge(models["jv"]["params"], ad.a, ad.b)}
        assert hp[i].tokens == ref_greedy(models["jm"], jm, prompt, n)
        assert hp[i].tokens == _merged_greedy(models, regs["port"],
                                              kw["adapter"], prompt, n)
    for i, spec in ((4, DIGITS3), (5, both)):
        assert hp[i].finish_reason is FinishReason.GRAMMAR
        assert compile_constraint(spec, VOCAB32).accepts(hp[i].tokens)
    _assert_snapshots_equal(port, engines["jax"])
    snap = port.metrics.snapshot()
    assert (snap["adapter_loads"], snap["adapter_hits"]) == (3, 1)
    assert snap["constrained_requests"] == 2
    assert snap["requests_grammar_complete"] == 2
    assert snap["requests_by_adapter"] == {"acme": 2, "globex": 1,
                                           "initech": 1}
    assert port.adapter_pool_resident == 3
    assert port.metrics.adapter_pool_resident == 3
    assert port._apool.pinned_rows() == []
    assert "requests_by_adapter[acme]" in port.metrics.summary()


@pytest.mark.parametrize("mode", MODES)
def test_prefix_blocks_shared_across_tenants(models, mode):
    """K/V is adapter-invariant: prompts that share a 12-token prefix under
    three adapters (and none) hit one cached chain, and every stream
    equals a prefix-off row engine's and its own merged-head oracle."""
    regs = _registries()
    shared = (np.arange(12) * 5 + 3) % V
    wave = [(np.concatenate([shared, [i, 2 * i + 1]]), 6,
             dict(adapter=name) if name else {})
            for i, name in enumerate([None, "acme", "globex", "initech"])]
    streams = {}
    for key, kw in (("shared", dict(paged=mode == "paged")),
                    ("off", dict(paged=False, prefix_cache_blocks=0))):
        eng = ServeEngine(models["tm"], device="cpu", max_slots=2,
                          prefill_len=16, prefix_block_size=4,
                          tenant=TenantConfig(registry=regs["port"]), **kw)
        hs = [eng.submit(p, n, **skw) for p, n, skw in wave]
        eng.run(max_steps=100)
        streams[key] = [h.tokens for h in hs]
        if key == "shared":
            assert eng.metrics.prefix_hits >= 2
            assert eng.metrics.prefill_tokens_saved >= 2 * 12 - 4
    assert streams["shared"] == streams["off"]
    for (prompt, n, kw), got in zip(wave[1:], streams["shared"][1:]):
        assert got == _merged_greedy(models, regs["port"], kw["adapter"],
                                     prompt, n)


def _recording(monkeypatch, logs):
    """Record every logits tensor the engine samples from, under
    ``logs["now"]``'s name."""
    real = engine_mod.sample_logits_batched

    def spy(rng, logits, **kw):
        logs[logs["now"]].append(logits.detach().clone())
        return real(rng, logits, **kw)
    monkeypatch.setattr(engine_mod, "sample_logits_batched", spy)


@pytest.mark.parametrize("mode", MODES)
def test_base_slots_bitwise_equal_to_the_plain_engine(models, mode,
                                                      monkeypatch):
    """Slots 0 and 2 hold the same base requests in both engines; beside
    them the tenant engine serves an adapter and an open-ended
    constraint (so every stream runs to LENGTH and the batches keep one
    shape). Their logits at admission and at every tick are bitwise the
    plain engine's."""
    digits = {"kind": "regex", "pattern": "[0-9]+"}
    kw = dict(max_slots=4, prefill_len=16, prefix_block_size=4,
              paged=mode != "row")
    tenant = ServeEngine(models["tm"], device="cpu", tenant=TenantConfig(
        registry=_registries()["port"], token_strings=VOCAB32), **kw)
    plain = ServeEngine(models["tm"], device="cpu", **kw)
    assert not plain.tenant_enabled and plain.adapter_registry is None
    assert plain.adapter_pool_resident == 0
    logs = {"tenant": [], "plain": []}
    # Warm both engines first: the record holds the traffic's sampling
    # calls only (warmup's dummy admission and dead tick sample too).
    tenant.warmup()
    plain.warmup()
    _recording(monkeypatch, logs)
    for name, eng, extra in (
            ("tenant", tenant, [dict(adapter="globex"),
                                dict(constraint=digits)]),
            ("plain", plain, [{}, {}])):
        logs["now"] = name
        hs = [eng.submit(_base(1), 10), eng.submit(_base(5), 10, **extra[0]),
              eng.submit(_base(2), 10), eng.submit(_base(9), 10, **extra[1])]
        eng.run(max_steps=100)
        assert all(h.finish_reason is FinishReason.LENGTH for h in hs)
        logs[name + "_tokens"] = [h.tokens for h in hs]
    assert len(logs["tenant"]) == len(logs["plain"]) == 4 + 9
    for i, (a, b) in enumerate(zip(logs["tenant"], logs["plain"])):
        if i < 4:  # the four admissions, one row each
            if i in (0, 2):
                assert torch.equal(a, b), i
            continue
        assert torch.equal(a[[0, 2]], b[[0, 2]]), i
        assert not torch.equal(a[1], b[1])  # the adapter moved its row
        assert torch.isinf(a[3]).any() and not torch.isinf(b[3]).any()
    for j in (0, 2):
        assert logs["tenant_tokens"][j] == logs["plain_tokens"][j]


@pytest.mark.parametrize("mode", MODES)
def test_json_schema_stream_finishes_grammar_as_jax(models, mode):
    schema = {"type": "object", "properties": {
        "ed": {"type": "boolean"}, "id": {"enum": [7, 42]}}}
    spec = {"kind": "json_schema", "schema": schema}
    eos = V - 1  # 'k': never inside this grammar
    wave = [((np.arange(10) * 7 + 3) % V, 24, dict(constraint=spec)),
            ((np.arange(9) * 5 + 1) % V, 24,
             dict(constraint=spec, adapter="globex"))]
    for eos_token in (None, eos):
        engines = _engines(models, mode, eos_token=eos_token)
        trace, handles = _run(engines, wave)
        assert trace["port"] == trace["jax"]
        fsm = compile_constraint(spec, VOCAB32)
        for hp, hj in zip(handles["port"], handles["jax"]):
            assert hp.tokens == hj.tokens
            assert hp.finish_reason.value == hj.finish_reason.value
            want = (FinishReason.GRAMMAR if eos_token is None
                    else FinishReason.EOS)
            assert hp.finish_reason is want
            assert fsm.accepts(hp.tokens, eos_token=eos_token)
            body = hp.tokens[:-1] if eos_token is not None else hp.tokens
            doc = json.loads("".join(VOCAB32[t] for t in body))
            assert doc["id"] in (7, 42) and isinstance(doc["ed"], bool)
        _assert_snapshots_equal(engines["port"], engines["jax"])


@pytest.mark.parametrize("mode", MODES)
def test_pool_churn_at_the_floor_matches_jax(models, mode):
    """Two slots on a pool of three rows (the floor: identity + one per
    slot) and five adapters: cold adapters evict the least recently used
    unpinned row; the evictions, loads and hits equal the JAX engine's
    and every stream is merged-exact."""
    names = ["t0", "t1", "t2", "t3", "t4"]
    regs = _registries(names, seed0=40)
    engines = _engines(models, mode, regs=regs, max_slots=2,
                       tenant_kw=dict(adapter_pool_slots=3))
    order = names + ["t0", "t3", "t1", None, "t4"]
    wave = [((np.arange(10) * 3 + 1 + i) % V, 4 + i % 3,
             dict(adapter=name) if name else {})
            for i, name in enumerate(order)]
    trace, handles = _run(engines, wave)
    assert trace["port"] == trace["jax"]
    for (prompt, n, kw), hp, hj in zip(wave, handles["port"],
                                       handles["jax"]):
        assert hp.tokens == hj.tokens
        if kw:
            assert hp.tokens == _merged_greedy(models, regs["port"],
                                               kw["adapter"], prompt, n)
    _assert_snapshots_equal(engines["port"], engines["jax"])
    port = engines["port"]
    assert port._apool.evictions == engines["jax"]._apool.evictions >= 5
    assert port.metrics.adapter_loads > len(names)
    assert port._apool.pinned_rows() == []
    with pytest.raises(ValueError, match="floor"):
        _engines(models, mode, regs=regs, max_slots=2,
                 tenant_kw=dict(adapter_pool_slots=2))


@pytest.mark.parametrize("mode", MODES)
def test_cold_adapter_load_charge_defers_admission_as_jax(models, mode):
    """Budget 24 with 12-token prompts: two base requests enter one step;
    with cold adapters (12 + 8 tokens each) the second waits a step. Then
    a resident adapter costs nothing and a cold one 8 tokens more than
    the base request. The per-step traces and every `_prefill_cost`
    equal the JAX engine's."""
    p1, p2 = (np.arange(12) * 5 + 1) % V, (np.arange(12) * 7 + 2) % V
    for adapters, admitted_first in (((None, None), 2),
                                     (("acme", "globex"), 1)):
        engines = _engines(models, mode, max_slots=2,
                           prefill_token_budget=24)
        wave = [(p, 3, dict(adapter=a) if a else {})
                for p, a in zip((p1, p2), adapters)]
        trace, handles = _run(engines, wave)
        assert trace["port"] == trace["jax"]
        assert trace["port"][0][1:] == (admitted_first, 2 - admitted_first)
        for hp, hj in zip(handles["port"], handles["jax"]):
            assert hp.tokens == hj.tokens
    costs = {}
    for name, eng in engines.items():  # acme and globex are resident
        hs = [eng.submit(p1, 3, adapter="acme"),
              eng.submit(p1, 3, adapter="initech"), eng.submit(p1, 3)]
        costs[name] = [eng._prefill_cost(h) for h in hs]
        eng.run(max_steps=50)
    assert costs["port"] == costs["jax"]
    warm, cold, base = costs["port"]
    assert warm == base and cold == base + 8


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (compared as type and words)
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    "plain_adapter", "plain_constraint", "unregistered", "bad_kind",
    "no_token_strings", "no_first_token", "below_floor", "registry_shape",
    "token_strings_length"])
def test_submit_and_construction_errors_match_jax(models, case):
    def build(pkg, **kw):
        eng_cls = JaxServeEngine if pkg == "jax" else ServeEngine
        extra = ({"variables": models["jv"], "preempt_cap": 0}
                 if pkg == "jax" else {"device": "cpu"})
        model = models["jm"] if pkg == "jax" else models["tm"]
        return eng_cls(model, **dict(dict(max_slots=2, prefill_len=16),
                                     **extra, **kw))

    def tenant(pkg, **kw):
        cfg = JaxTenantConfig if pkg == "jax" else TenantConfig
        reg = kw.pop("registry", _registries()[pkg])
        return cfg(registry=reg, **kw)

    def attempt(pkg):
        if case == "plain_adapter":
            return build(pkg).submit([1, 2, 3], 2, adapter="acme")
        if case == "plain_constraint":
            return build(pkg).submit([1, 2, 3], 2, constraint=DIGITS3)
        if case == "below_floor":
            return build(pkg, max_slots=4,
                         tenant=tenant(pkg, adapter_pool_slots=3))
        if case == "registry_shape":
            reg = (JaxRegistry if pkg == "jax" else AdapterRegistry)(16, V)
            return build(pkg, tenant=tenant(pkg, registry=reg))
        if case == "token_strings_length":
            return build(pkg, tenant=tenant(pkg,
                                            token_strings=VOCAB32[:-1]))
        if case == "no_token_strings":
            return build(pkg, tenant=tenant(pkg)).submit(
                [1, 2, 3], 2, constraint=DIGITS3)
        eng = build(pkg, tenant=tenant(pkg, token_strings=VOCAB32))
        spec = {"unregistered": None, "bad_kind": {"kind": "wat"},
                "no_first_token": {"kind": "regex", "pattern": "x*"}}[case]
        if case == "unregistered":
            return eng.submit([1, 2, 3], 2, adapter="nobody")
        return eng.submit([1, 2, 3], 2, constraint=spec)

    got = {pkg: _error(lambda: attempt(pkg)) for pkg in ("jax", "port")}
    assert got["port"] is not None and got["port"][0] == "ValueError"
    assert got["port"] == got["jax"]


def test_tenant_config_fields_and_defaults_match_jax(models):
    import dataclasses

    fields = [(f.name, f.default) for f in dataclasses.fields(TenantConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JaxTenantConfig)]
    eng = ServeEngine(models["tm"], device="cpu", max_slots=3,
                      tenant=TenantConfig())
    assert eng._apool.slots == 3 + 4  # auto-sized: max_slots + 4
    assert isinstance(eng.adapter_registry, AdapterRegistry)
    assert eng._apool_a.shape == (7, 32, 8) and eng._apool_b.shape == (7, 8,
                                                                        V)
    assert eng._apool_a.dtype == torch.float32


@pytest.mark.parametrize("mode", ["row", "paged", "draft"])
def test_spec_k3_with_constraints_matches_jax(models, mode):
    """Speculation under tenancy: constrained greedy rows walk their FSM
    along the drafts (caps at the legal prefix), every row's verify adds
    its adapter's delta at every position, a sampled constrained row
    draws under its mask; step for step the JAX engine's tokens, per
    handle spec counters and snapshot."""
    loop = np.resize(np.array([3, 1, 4, 1, 5]), 18)
    digits = {"kind": "regex", "pattern": "[0-9]+"}
    wave = [(loop, 14, dict(constraint=digits)),
            (loop, 12, dict(adapter="acme")),
            (_base(4), 10, dict(adapter="globex", constraint=DIGITS3)),
            (np.resize(np.array([7, 2]), 12), 12, {}),
            (_base(6), 8, dict(constraint=digits,
                               sampling=dict(temperature=0.8, top_k=1)))]
    engines = _engines(models, "paged" if mode == "draft" else mode,
                       spec_k=3, max_slots=4, prefill_len=24,
                       draft=mode == "draft")
    trace, handles = _run(engines, wave)
    assert trace["port"] == trace["jax"]
    fsms = {i: compile_constraint(wave[i][2]["constraint"], VOCAB32)
            for i in (0, 2, 4)}
    for i, (hp, hj) in enumerate(zip(handles["port"], handles["jax"])):
        assert hp.tokens == hj.tokens, i
        assert hp.finish_reason.value == hj.finish_reason.value
        assert (hp.spec_drafted, hp.spec_accepted) == (hj.spec_drafted,
                                                       hj.spec_accepted)
        if i in fsms:
            fsms[i].advance_many(hp.tokens)  # every token mask-legal
    assert handles["port"][2].finish_reason is FinishReason.GRAMMAR
    assert handles["port"][4].spec_drafted == 0
    _assert_snapshots_equal(engines["port"], engines["jax"])
    snap = engines["port"].metrics.snapshot()
    assert 0 < snap["spec_accepted_tokens"] <= snap["spec_drafted_tokens"]
    assert engines["port"]._apool.pinned_rows() == []


@pytest.mark.parametrize("mode", MODES)
def test_cancels_and_expiries_release_every_pin(models, mode):
    """Adapted streams cancelled in their slot, in the queue, and expired
    at their deadline: the same finish reasons and counters as the JAX
    engine, and no pool row left pinned in either."""
    clocks = {"jax": FakeClock(), "port": FakeClock()}
    regs = _registries()
    jeng = JaxServeEngine(models["jm"], models["jv"], preempt_cap=0,
                          max_slots=2, prefill_len=16, paged=mode != "row",
                          clock=clocks["jax"], tenant=JaxTenantConfig(
                              registry=regs["jax"], token_strings=VOCAB32))
    teng = ServeEngine(models["tm"], device="cpu", max_slots=2,
                       prefill_len=16, paged=mode != "row",
                       clock=clocks["port"], tenant=TenantConfig(
                           registry=regs["port"], token_strings=VOCAB32))
    engines = {"jax": jeng, "port": teng}
    hs = {}
    for name, eng in engines.items():
        hs[name] = [eng.submit(_base(0), 20, adapter="acme"),
                    eng.submit(_base(1), 20, adapter="globex",
                               constraint={"kind": "regex",
                                           "pattern": "[0-9]+"},
                               deadline_s=5.0),
                    eng.submit(_base(2), 20, adapter="initech")]
    for step in range(30):
        for name, eng in engines.items():
            if step == 2:
                hs[name][0].cancel()
                hs[name][2].cancel()  # still queued
            if step == 4:
                clocks[name].now = 10.0
            eng.step()
        if not any(e.has_work for e in engines.values()):
            break
    for name, eng in engines.items():
        assert not eng.has_work
        assert eng._apool.pinned_rows() == []
        assert [h.state for h in hs[name]][0].value == "cancelled"
    for hp, hj in zip(hs["port"], hs["jax"]):
        assert hp.tokens == hj.tokens
        assert hp.finish_reason.value == hj.finish_reason.value
        assert hp.state.value == hj.state.value
    assert hs["port"][1].state is RequestState.TIMED_OUT
    _assert_snapshots_equal(teng, jeng)
    assert teng._masks.all() and all(f is None for f in teng._fsms)


def test_package_exports_the_tenant_names():
    """The port's package exports what the JAX package's serving package
    exports for tenancy (``AdapterRegistry``, ``TenantConfig``), and the
    constraint compiler, lazily."""
    import pddl_tpu.serve as jserve
    import pddl_tpu_torch

    assert {"AdapterRegistry", "TenantConfig"} <= set(jserve.__all__)
    for name in ("AdapterRegistry", "TenantConfig", "compile_constraint"):
        assert name in pddl_tpu_torch.__all__
    assert pddl_tpu_torch.TenantConfig is TenantConfig
    assert pddl_tpu_torch.AdapterRegistry is AdapterRegistry
    assert pddl_tpu_torch.compile_constraint is compile_constraint
