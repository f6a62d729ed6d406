"""Fault tolerance and preemption of the port's serving engine
(`pddl_tpu_torch/serve/faults.py`, the engine's retry, replay, degraded
and preemption paths) against the JAX engine on the CPU, from the same
bridged `tiny_gpt` weights (vocabulary 32, `max_len` 64).

- The chaos matrix: `tests/test_serve_faults.py`'s workload under each of
  its fault profiles, stepped in lockstep with the JAX engine under a
  `FaultPlan` of the same seed: the injected `(step, site, kind)` lists,
  the tokens, live slots and queue depth at every step and the clock-free
  snapshot (the 12 resilience and host-tier keys included, with a fake
  clock for `degraded_time_s`) are equal. Seed 0 runs in both modes,
  seeds 1 and 2 in paged mode only.
- `spec_k=4` (n-gram drafts, both modes; a draft model, paged) and a
  tenant engine (an adapter stream and a constrained one) under a
  scheduled tick exhaustion: the speculative replay's forced re-feeds and
  the adapter's re-admission, step for step the JAX engine's.
- The JAX file's targeted scenarios on the port: retry in place,
  exhausted retries replaying token-exact, a replay's wait in the queue,
  the replay budget failing the request and not the engine, OOM →
  degraded → flush → re-arm, a real `torch.OutOfMemoryError` at a call
  that writes the slot cache never re-dispatched, the kill point, and the
  plan's determinism and validation (the same draws as the JAX plan).
- `classify`: the allocator's OOM is `"oom"`, any other CUDA error is
  left unclassified and propagates out of the engine.
- Preemption at both packages' defaults (`preempt_cap=2`), off at 0, and
  the replay lane outranking every class.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock, ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.serve import FaultPlan as JaxFaultPlan
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.faults import FaultKind as JaxFaultKind
from pddl_tpu.serve.faults import FaultSpec as JaxFaultSpec
from pddl_tpu.serve.request import Priority as JaxPriority
from pddl_tpu.serve.tenant import AdapterRegistry as JaxRegistry
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.models.gpt import tiny_gpt
from pddl_tpu_torch.serve import (
    FaultKind,
    FaultPlan,
    FaultSpec,
    FinishReason,
    KillPoint,
    Priority,
    RequestState,
    ServeEngine,
)
from pddl_tpu_torch.serve.request import Request, RequestHandle
from pddl_tpu_torch.serve.scheduler import SLOScheduler
from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig
from pddl_tpu_torch.utils.faults import classify

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

V, MAX_LEN = 32, 64
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))
SCHEMA = {"kind": "json_schema", "schema": {
    "type": "object", "properties": {"ab": {"type": "boolean"}}}}

# The JAX file's workload and fault profiles.
_WORKLOAD = [((np.arange(9) * 5 + 1) % 32, 6),
             ((np.arange(12) * 3 + 7) % 32, 5),
             ((np.arange(9) * 5 + 1) % 32, 4),   # shared prefix with #0
             ((np.arange(6) + 17) % 32, 7),
             ((np.arange(14) * 7 + 2) % 32, 3)]
_PROFILES = {
    "transient": dict(transient_rate=0.08, max_random_injections=12),
    "oom": dict(oom_rate=0.05, max_random_injections=6),
    "latency": dict(latency_rate=0.25, latency_s=1e-4,
                    max_random_injections=30),
    "mixed": dict(transient_rate=0.05, oom_rate=0.02, latency_rate=0.1,
                  latency_s=1e-4, max_random_injections=20),
}
# The twelve snapshot keys this slice brings.
NEW_KEYS = ("retries", "retry_sites", "replays", "preemptions",
            "requests_failed", "degraded_entries", "degraded_time_s",
            "host_tier_spills", "host_tier_hits", "host_tier_promotions",
            "host_tier_promote_tokens_charged", "host_tier_bytes_resident")


def _no_sleep(_):
    pass


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_gpt(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params)))
    jd = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=1)
    dparams = {k: v for k, v in params.items() if k != "block1"}
    td = tiny_gpt(vocab_size=V, max_len=MAX_LEN, depth=1, device="cpu")
    td.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray,
                                                        dparams)))
    return dict(jm=jm, jv={"params": params}, tm=tm, jd=jd,
                jdv={"params": dparams}, td=td)


def _plans(**plan_kw):
    """One plan per package, the same seed and profile, each recording
    its injections as ``(step, site, kind)``."""
    spec = plan_kw.pop("scheduled", ())
    out = {}
    for name, plan_cls, spec_cls, kind_cls in (
            ("jax", JaxFaultPlan, JaxFaultSpec, JaxFaultKind),
            ("port", FaultPlan, FaultSpec, FaultKind)):
        plan = plan_cls(sleep_fn=_no_sleep, scheduled=[
            spec_cls(step, site, kind_cls(kind), count)
            for step, site, kind, count in spec], **plan_kw)
        log = []
        plan.on_inject = lambda step, site, kind, _log=log: _log.append(
            (step, site, kind))
        out[name] = (plan, log)
    return out


def _engines(models, plans, **kw):
    """The JAX and the port engine at the same options, each with its
    plan, a no-op backoff and a fake clock."""
    jkw, tkw = dict(kw), dict(kw)
    if "spec_draft_model" in kw:
        jkw.update(spec_draft_model=models["jd"],
                   spec_draft_variables=models["jdv"])
        tkw["spec_draft_model"] = models["td"]
    if "tenant" in kw:
        regs = {"jax": JaxRegistry(32, V, rank=4),
                "port": AdapterRegistry(32, V, rank=4)}
        for reg in regs.values():
            reg.register_random("acme", seed=100, scale=0.1)
        jkw["tenant"] = JaxTenantConfig(registry=regs["jax"],
                                        token_strings=VOCAB32)
        tkw["tenant"] = TenantConfig(registry=regs["port"],
                                     token_strings=VOCAB32)
    clocks = {"jax": FakeClock(), "port": FakeClock()}
    return {
        "jax": JaxServeEngine(models["jm"], models["jv"],
                              fault_plan=plans["jax"][0],
                              backoff_sleep=_no_sleep, clock=clocks["jax"],
                              **jkw),
        "port": ServeEngine(models["tm"], device="cpu",
                            fault_plan=plans["port"][0],
                            backoff_sleep=_no_sleep, clock=clocks["port"],
                            **tkw)}, clocks


def _run(engines, clocks, wave, max_steps=600):
    """Submit the wave to both engines and step them in lockstep (each
    fake clock a second a step) until both drain; returns the per-step
    (tokens, live slots, queue depth) traces and the handles."""
    trace = {name: [] for name in engines}
    handles = {name: [] for name in engines}
    for name, eng in engines.items():
        for prompt, n, *kw in wave:
            handles[name].append(eng.submit(prompt, n, **(kw[0] if kw
                                                            else {})))
    for _ in range(max_steps):
        if not any(e.has_work for e in engines.values()):
            break
        for name, eng in engines.items():
            trace[name].append((eng.step(), eng.live_slots,
                                eng.scheduler.depth))
            clocks[name].now += 1.0
    return trace, handles


def _assert_lockstep(engines, plans, trace, handles):
    assert plans["port"][1] == plans["jax"][1]
    assert trace["port"] == trace["jax"]
    for hp, hj in zip(handles["port"], handles["jax"]):
        assert hp.tokens == hj.tokens
        assert hp.state.value == hj.state.value
        assert hp.replays == hj.replays
    ours = engines["port"].metrics.snapshot()
    ref = engines["jax"].metrics.snapshot()
    for key in NEW_KEYS:
        assert ours[key] == ref[key], key
    timed = ("ttft", "latency", "tokens_per_s")
    for key, val in ours.items():
        if not any(t in key for t in timed):
            assert val == ref[key], key
    assert engines["port"].degraded == engines["jax"].degraded


@pytest.mark.parametrize("seed,mode", [(0, "row"), (0, "paged"),
                                       (1, "paged"), (2, "paged")])
@pytest.mark.parametrize("profile", sorted(_PROFILES))
def test_chaos_lockstep_vs_jax(models, profile, seed, mode):
    """The JAX chaos matrix's workload and profiles, step for step: the
    same injections at the same coordinates, the same tokens at every
    step, every survivor equal to the fault-free stream."""
    plans = _plans(seed=seed, **_PROFILES[profile])
    engines, clocks = _engines(models, plans, max_slots=2, prefill_len=16,
                               paged=mode == "paged")
    trace, handles = _run(engines, clocks, _WORKLOAD)
    assert not engines["port"].has_work
    _assert_lockstep(engines, plans, trace, handles)
    for h, (p, n) in zip(handles["port"], _WORKLOAD):
        assert h.done
        if h.state is RequestState.FINISHED:
            assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
    assert ({k.value: v for k, v in plans["port"][0].injected.items()}
            == {k.value: v for k, v in plans["jax"][0].injected.items()})


_SPEC_WAVE = [(np.resize((np.arange(5) * 7 + 3) % V, 14), 24),
              ((np.arange(11) * 3 + 2) % V, 18),
              (np.resize((np.arange(4) + 9) % V, 13), 20)]


@pytest.mark.parametrize("mode", ["row", "paged", "draft"])
def test_spec_replay_forced_refeed_lockstep(models, mode):
    """A tick exhaustion mid-stream at ``spec_k=4``: every live stream
    replays, re-feeding its emitted tokens ``spec_k + 1`` a window (and
    teacher-forcing them through the draft model), step for step the JAX
    engine's, then a seeded mixed storm on the same engine kind."""
    kw = dict(max_slots=3, prefill_len=16, prefix_block_size=4, spec_k=4,
              paged=mode != "row", max_retries=1)
    if mode == "draft":
        kw["spec_draft_model"] = True
    for plan_kw in (dict(scheduled=[(4, "verify", "transient", 2)]),
                    dict(seed=0, transient_rate=0.05, oom_rate=0.02,
                         latency_rate=0.1, latency_s=1e-4,
                         max_random_injections=20)):
        plans = _plans(**plan_kw)
        engines, clocks = _engines(models, plans, **kw)
        trace, handles = _run(engines, clocks, _SPEC_WAVE)
        _assert_lockstep(engines, plans, trace, handles)
        for hp, hj in zip(handles["port"], handles["jax"]):
            assert (hp.spec_drafted, hp.spec_accepted) == (
                hj.spec_drafted, hj.spec_accepted)
        for h, (p, n) in zip(handles["port"], _SPEC_WAVE):
            assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
        assert engines["port"].metrics.replays > 0


@pytest.mark.parametrize("mode", ["row", "paged"])
def test_tenant_replay_lockstep(models, mode):
    """A tenant engine under a tick exhaustion: the adapter stream and the
    constrained one replay (the adapter re-acquired with ``fresh=False``,
    the FSM state re-derived from the stream), token for token the JAX
    engine's, and ``requests_by_adapter`` counts each request once."""
    plans = _plans(scheduled=[(3, "tick", "transient", 9)])
    engines, clocks = _engines(models, plans, max_slots=3, prefill_len=16,
                               prefix_block_size=4, paged=mode == "paged",
                               tenant=True, max_retries=2)
    base = (np.arange(11) * 3 + 2) % V
    wave = [(base, 6), (base, 7, {"adapter": "acme"}),
            (base, 12, {"adapter": "acme", "constraint": SCHEMA})]
    trace, handles = _run(engines, clocks, wave)
    _assert_lockstep(engines, plans, trace, handles)
    snap = engines["port"].metrics.snapshot()
    assert snap["replays"] >= 2
    assert snap["requests_by_adapter"] == {"acme": 2}


# ------------------------------------------------- the JAX file's scenarios
def _port_engine(models, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_len", 16)
    kw.setdefault("backoff_sleep", _no_sleep)
    return ServeEngine(models["tm"], device="cpu", **kw)


def test_transient_tick_retry_recovers_in_place(models):
    p, n = (np.arange(7) * 4 + 3) % 32, 6
    plan = FaultPlan(scheduled=[FaultSpec(step=2, site="tick",
                                          kind=FaultKind.TRANSIENT,
                                          count=2)])
    eng = _port_engine(models, fault_plan=plan, max_retries=3)
    h = eng.submit(p, n)
    eng.run(max_steps=100)
    assert h.state == RequestState.FINISHED
    assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
    assert eng.metrics.retries == 2
    assert eng.metrics.retry_sites == {"tick": 2}
    assert eng.metrics.replays == 0
    rec = next(r for r in eng.telemetry.snapshot() if r["step"] == 2)
    assert rec["retries"] == 2 and "tick" in rec["site_wall_s"]


def test_tick_retries_exhausted_replays_token_exact(models):
    reqs = [((np.arange(8) * 3 + 1) % 32, 7), ((np.arange(5) + 9) % 32, 6)]
    plan = FaultPlan(scheduled=[FaultSpec(step=3, site="tick",
                                          kind=FaultKind.TRANSIENT,
                                          count=8)])
    eng = _port_engine(models, fault_plan=plan, max_retries=2)
    handles = [eng.submit(p, n) for p, n in reqs]
    eng.run(max_steps=100)
    for h, (p, n) in zip(handles, reqs):
        assert h.state == RequestState.FINISHED
        assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
        assert h.replays == 1
    assert eng.metrics.replays == 2
    assert eng.metrics.retries == 2


def test_replay_waits_in_the_front_lane_one_step(models):
    """The JAX file's replay-queue-wait scenario without a tracer: the
    stream lost at step 3 is requeued in the front lane and re-admitted
    at step 4 (one fake-clock second later), then finishes exact."""
    clock = FakeClock()
    plan = FaultPlan(scheduled=[FaultSpec(step=3, site="tick",
                                          kind=FaultKind.TRANSIENT,
                                          count=8)])
    eng = _port_engine(models, max_slots=1, clock=clock, fault_plan=plan,
                       max_retries=2)
    p = (np.arange(8) * 3 + 1) % 32
    h = eng.submit(p, 7)
    states = []
    for _ in range(100):
        if h.done:
            break
        eng.step()
        states.append((eng._step_idx - 1, h.state, eng.scheduler.depth))
        clock.now += 1.0
    assert states[3] == (3, RequestState.QUEUED, 1)  # requeued mid-step 3
    assert states[4][1] is RequestState.RUNNING      # re-admitted at 4
    assert h.state == RequestState.FINISHED and h.replays == 1
    assert h.ttft_s == 0.0  # the first admission's TTFT stands
    assert h.tokens == ref_greedy(models["jm"], models["jv"], p, 7)


def test_replay_budget_exhausted_fails_request_not_engine(models):
    plan = FaultPlan(sites=("tick",), transient_rate=1.0)
    eng = _port_engine(models, fault_plan=plan, max_retries=1,
                       max_replays=2)
    handles = [eng.submit((np.arange(4) + i) % 32, 5) for i in range(2)]
    eng.run(max_steps=60)
    assert not eng.has_work
    for h in handles:
        assert h.state == RequestState.FAILED
        assert h.finish_reason == FinishReason.ERROR
        assert h.replays == 3
        assert len(h.tokens) == 1
    snap = eng.metrics.snapshot()
    assert snap["requests_failed"] == 2
    assert snap["requests_finished"] == 0
    assert eng.step() == 0


@pytest.mark.parametrize("site", ["gather", "donate"])
def test_oom_degrades_flushes_and_rearms(models, site):
    """An OOM on the gather (the JAX file's case) or the donation: the
    unpinned pool blocks are flushed, donations stop, serving continues
    cold and token-exact, and the cache re-arms after the cool-down."""
    clock = FakeClock()
    p = (np.arange(12) * 5 + 1) % 32
    ref = ref_greedy(models["jm"], models["jv"], p, 4)
    plan = FaultPlan()
    eng = _port_engine(models, max_slots=1, clock=clock, fault_plan=plan,
                       degraded_cooldown_s=5.0)
    if site == "donate":
        plan._sched[(0, "donate")] = [FaultKind.OOM]
    h0 = eng.submit(p, 4)
    eng.run(max_steps=50)
    assert h0.tokens == ref
    if site == "gather":
        assert eng._prefix.blocks_live > 0
        plan._sched[(eng._step_idx, "gather")] = [FaultKind.OOM]
        h1 = eng.submit(p, 4)
        eng.run(max_steps=50)
        assert h1.tokens == ref and h1.replays == 1
    else:
        assert h0.replays == 1
    assert eng.degraded
    assert eng._prefix.blocks_live == 0
    assert eng.metrics.degraded_entries == 1
    lookups = eng.metrics.prefix_lookups
    h2 = eng.submit(p, 4)
    eng.run(max_steps=50)
    assert h2.tokens == ref
    assert eng.metrics.prefix_lookups == lookups
    assert eng._prefix.blocks_live == 0
    clock.now += 6.0
    h3 = eng.submit(p, 4)
    eng.run(max_steps=50)
    assert not eng.degraded
    assert eng.metrics.degraded_time_s > 0
    assert h3.tokens == ref
    assert eng._prefix.blocks_live > 0
    hits = eng.metrics.prefix_hits
    h4 = eng.submit(p, 4)
    eng.run(max_steps=50)
    assert h4.tokens == ref
    assert eng.metrics.prefix_hits == hits + 1


def test_real_oom_on_a_slot_cache_write_never_redispatches(models):
    """A REAL ``torch.OutOfMemoryError`` from the insert (a call that
    writes the slot cache in place) escalates at once: no retry, the
    engine degrades, the slot cache is rebuilt and the live neighbour
    replays — the same counters as the JAX engine given an
    ``XlaRuntimeError`` RESOURCE_EXHAUSTED there."""
    reqs = [((np.arange(6) * 3 + 2) % 32, 6), ((np.arange(9) + 5) % 32, 5)]
    FakeXla = type("XlaRuntimeError", (RuntimeError,), {})
    results = {}
    for name in ("jax", "port"):
        if name == "jax":
            eng = JaxServeEngine(models["jm"], models["jv"], max_slots=2,
                                 prefill_len=16, backoff_sleep=_no_sleep)
            eng.warmup()
            attr, err = "_insert_p", FakeXla(
                "RESOURCE_EXHAUSTED: out of memory mid-dispatch")
        else:
            eng = _port_engine(models)
            attr, err = None, torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        h0 = eng.submit(*reqs[0])
        eng.step()
        assert h0.state.value == "running"
        calls = {"n": 0}
        if name == "jax":
            real = getattr(eng, attr)

            def flaky(*args, _real=real):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise err
                return _real(*args)
            setattr(eng, attr, flaky)
        else:
            import pddl_tpu_torch.serve.engine as engine_mod
            real = engine_mod.insert_cache_slot

            def flaky(*args, _real=real):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise err
                return _real(*args)
            engine_mod.insert_cache_slot = flaky
        try:
            h1 = eng.submit(*reqs[1])
            eng.run(max_steps=100)
        finally:
            if name == "port":
                engine_mod.insert_cache_slot = real
        for h, (p, n) in zip((h0, h1), reqs):
            assert h.state.value == "finished"
            assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
        snap = eng.metrics.snapshot()
        results[name] = ({k: snap[k] for k in NEW_KEYS}, h0.replays,
                         h1.replays, calls["n"])
    assert results["port"] == results["jax"]
    counters, r0, r1, _ = results["port"]
    assert counters["retries"] == 0 and counters["degraded_entries"] == 1
    assert r0 == r1 == 1


def test_non_oom_cuda_error_propagates_unclassified(models):
    """Any CUDA error but the allocator's OOM leaves the context unusable:
    ``classify`` leaves it unclassified and the engine lets it out."""
    illegal = RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    assert classify(illegal) is None
    assert classify(torch.OutOfMemoryError("CUDA out of memory")) == "oom"
    assert classify(torch.cuda.OutOfMemoryError("x")) == "oom"
    assert classify(ValueError("shape")) is None
    eng = _port_engine(models)
    eng.submit((np.arange(6) + 1) % 32, 5)
    eng.step()

    def broken():
        raise illegal
    eng._tick = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()
    assert eng.metrics.retries == 0 and eng.metrics.replays == 0
    assert not eng.degraded


def test_kill_point_unwinds_step_with_host_state_intact(models):
    """A KILL (a BaseException) aborts ``step()`` like a real SIGKILL; no
    retry path swallows it, and the host-side state survives: the tokens
    streamed so far, the live slots, the queue."""
    reqs = [((np.arange(8) * 5 + 3) % 32, 7), ((np.arange(6) + 1) % 32, 6),
            ((np.arange(10) * 3 + 9) % 32, 5)]
    plan = FaultPlan(scheduled=[FaultSpec(step=2, site="tick",
                                          kind=FaultKind.KILL)])
    eng = _port_engine(models, fault_plan=plan)
    handles = [eng.submit(p, n) for p, n in reqs]
    with pytest.raises(KillPoint) as info:
        eng.run(max_steps=100)
    assert (info.value.step, info.value.site) == (2, "tick")
    assert [len(h.tokens) for h in handles] == [3, 3, 0]
    assert eng.live_slots == 2 and eng.scheduler.depth == 1
    assert eng.metrics.retries == eng.metrics.replays == 0
    for h, (p, n) in zip(handles, reqs):
        want = ref_greedy(models["jm"], models["jv"], p, n)
        assert h.tokens == want[:len(h.tokens)]


def test_fault_plan_determinism_and_validation():
    """Same seed + same call sequence = same injections, and the same ones
    as the JAX plan's; bad configs are loud; SITES is the JAX tuple."""
    assert FaultPlan.SITES == JaxFaultPlan.SITES
    assert len(FaultPlan.SITES) == 13

    def drive(plan):
        fired = []
        plan.on_step(0)
        for i in range(200):
            try:
                plan.check("tick")
            except Exception as e:
                fired.append((i, type(e).__name__))
        return fired

    kw = dict(transient_rate=0.1, oom_rate=0.05, sleep_fn=_no_sleep)
    a = drive(FaultPlan(seed=3, **kw))
    assert a and a == drive(FaultPlan(seed=3, **kw))
    assert a != drive(FaultPlan(seed=4, **kw))
    assert a == drive(JaxFaultPlan(seed=3, **kw))
    with pytest.raises(ValueError, match="sum to <= 1"):
        FaultPlan(transient_rate=0.8, oom_rate=0.4)
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(sites=("warp_core",))
    with pytest.raises(ValueError, match="unknown scheduled site"):
        FaultPlan(scheduled=[FaultSpec(0, "nope", FaultKind.KILL)])
    plan = FaultPlan(seed=0, latency_rate=1.0, latency_s=2.5,
                     max_random_injections=3, sleep_fn=_no_sleep)
    slept = []
    plan._sleep = slept.append
    plan.on_step(0)
    for _ in range(10):
        plan.check("tick")
    assert slept == [2.5] * 3
    assert plan.injected[FaultKind.LATENCY] == 3


@pytest.mark.parametrize("kw", [{"max_retries": -1}, {"max_replays": -1},
                                {"preempt_cap": -1}])
def test_negative_knobs_raise_the_jax_error(models, kw):
    errors = []
    for build in (lambda: JaxServeEngine(models["jm"], models["jv"],
                                         max_slots=2, prefill_len=16, **kw),
                  lambda: _port_engine(models, **kw)):
        with pytest.raises(ValueError, match="must be >= 0") as info:
            build()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------- preemption
def test_interactive_preempts_best_effort_at_both_defaults(models):
    """`tests/test_serve_slo.py`'s wave at both packages' DEFAULT
    ``preempt_cap`` (2): two BEST_EFFORT streams fill both slots, an
    INTERACTIVE request arrives, one victim is parked on the next step in
    each engine and resumes token-exactly through replay."""
    be_p = [(np.arange(7) + i) % 32 for i in range(2)]
    ia_p = (np.arange(8) * 3 + 1) % 32
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            eng = JaxServeEngine(models["jm"], models["jv"], max_slots=2,
                                 prefill_len=16, prefix_cache_blocks=0)
            pri = JaxPriority
        else:
            eng = ServeEngine(models["tm"], device="cpu", max_slots=2,
                              prefill_len=16, prefix_cache_blocks=0)
            pri = Priority
        be = [eng.submit(p, 20, priority=pri.BEST_EFFORT) for p in be_p]
        eng.step()
        assert eng.live_slots == 2
        ia = eng.submit(ia_p, 4, priority=pri.INTERACTIVE)
        eng.step()
        assert eng.metrics.preemptions == 1
        assert sum(1 for h in be if h.state.value == "queued") == 1
        assert ia.state.value in ("running", "finished")
        eng.run(max_steps=200)
        assert ia.tokens == ref_greedy(models["jm"], models["jv"], ia_p, 4)
        for p, h in zip(be_p, be):
            assert h.state.value == "finished"
            assert h.tokens == ref_greedy(models["jm"], models["jv"], p, 20)
        assert max(h.preemptions for h in be) == 1
        out[name] = ([h.tokens for h in be + [ia]],
                     [h.replays for h in be], eng.metrics.snapshot()["replays"])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_preemption_lockstep_vs_jax(models, paged):
    """A best-effort wave then interactive arrivals, step for step the
    JAX engine's at the default cap, with the prefix cache on."""
    plans = _plans()
    engines, clocks = _engines(models, plans, max_slots=2, prefill_len=16,
                               prefix_block_size=4, paged=paged)
    be = [((np.arange(9) * 5 + i) % 32, 14) for i in range(3)]
    prios = {"jax": JaxPriority, "port": Priority}
    handles = {name: [eng.submit(p, n, priority=prios[name].BEST_EFFORT)
                      for p, n in be] for name, eng in engines.items()}
    for name, eng in engines.items():
        eng.step()
        eng.step()
    trace, more = _run(engines, clocks, [
        ((np.arange(7) * 3 + 1) % 32, 5),
        ((np.arange(9) * 5 + 1) % 32, 4)])
    _assert_lockstep(engines, plans, trace, more)
    for hp, hj in zip(handles["port"], handles["jax"]):
        assert hp.tokens == hj.tokens
        assert hp.preemptions == hj.preemptions
    assert engines["port"].metrics.preemptions > 0


def test_preempt_cap_zero_disables_preemption(models):
    eng = _port_engine(models, max_slots=1, prefix_cache_blocks=0,
                       preempt_cap=0)
    be = eng.submit(np.arange(6) % 32, 10, priority=Priority.BEST_EFFORT)
    eng.step()
    eng.submit((np.arange(5) + 2) % 32, 2, priority=Priority.INTERACTIVE)
    eng.step()
    assert be.state == RequestState.RUNNING
    assert eng.metrics.preemptions == 0
    eng.run(max_steps=100)


def _handle(priority):
    return RequestHandle(Request(prompt=[1, 2, 3], max_new_tokens=2,
                                 priority=priority), arrival_s=0.0)


def test_requeue_front_outranks_every_class():
    sched = SLOScheduler(max_queue_depth=16)
    replayed = _handle(Priority.BEST_EFFORT)
    sched.submit(_handle(Priority.INTERACTIVE))
    sched.requeue_front([replayed])
    assert sched.depth == 2
    assert sched.depth_at_or_above(Priority.INTERACTIVE) == 2
    assert sched.queued_of_class(Priority.BEST_EFFORT) == 0
    out = sched.admit(1, now_fn=lambda: 0.0)
    assert out == [replayed]
    preempted = _handle(Priority.BEST_EFFORT)
    sched.requeue(preempted)  # the normal lane: behind the interactive
    assert sched.queued_of_class(Priority.BEST_EFFORT) == 1
    assert sched.admit(2, now_fn=lambda: 0.0)[1] is preempted
