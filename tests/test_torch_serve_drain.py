"""Drain and restore in the port's serving engine (`serve/drain.py`,
`ServeEngine.drain`/`restore`/`install_drain_handler`) against the JAX
engine on the CPU, from the same bridged `tiny_gpt` weights (vocabulary
32, `max_len` 64).

- The JAX tests on the port: the SIGTERM round trip, a kill point's state
  still drainable, the deadline budget surviving, priority and deadline
  round-tripping, v1 snapshots (`test_serve_faults.py`,
  `test_serve_slo.py`); a kill mid-verify, v5 round trips into `spec_k` 3
  and 0 in both modes, v1-v4 into a speculative engine
  (`test_serve_spec.py`); the paged round trip with its v2-shaped twin
  (`test_serve_paged.py`); v4 tenant round trips, v1-v3 with tenant
  defaults, the plain engine's refusal (`test_serve_tenant.py`); a kill
  mid-promotion and a drain with the host tier populated
  (`test_kv_tier.py`). Every restored stream equals JAX `generate`'s.
- Across the packages: a snapshot either engine drains restores into the
  other, row and paged, token for token the JAX engine's continuation;
  on the same workload under a shared fake clock the two snapshots' JSON
  are equal but for ``drained_unix_s`` and the telemetry's wall times;
  `tests/_serve_drain_child.py` (a JAX engine in its own process) drains
  to disk and the port's engine, on the same seeded weights bridged,
  restores it token-exact against the JAX engine's continuation.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pddl_tpu.serve.drain as jax_drain
from conftest import FakeClock, ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.kvcache import HostTierConfig as JaxHostTierConfig
from pddl_tpu.serve.tenant import AdapterRegistry as JaxRegistry
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.models.gpt import GPT, tiny_gpt
from pddl_tpu_torch.serve import (
    FaultKind,
    FaultPlan,
    FaultSpec,
    KillPoint,
    Priority,
    RequestState,
    ServeEngine,
)
from pddl_tpu_torch.serve import drain as drain_io
from pddl_tpu_torch.serve.tenant import (
    AdapterRegistry,
    TenantConfig,
    compile_constraint,
)

V, MAX_LEN = 32, 64
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))
# `test_serve_spec.py`'s workload (#2 shares #0's prefix).
_WORKLOAD = [((np.arange(9) * 5 + 1) % 32, 9),
             ((np.arange(12) * 3 + 7) % 32, 6),
             ((np.arange(9) * 5 + 1) % 32, 5),
             ((np.arange(6) + 17) % 32, 8),
             ((np.arange(14) * 7 + 2) % 32, 4)]


def _no_sleep(_):
    pass


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny_gpt(vocab_size=V, max_len=MAX_LEN)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = tiny_gpt(vocab_size=V, max_len=MAX_LEN, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(jax.tree.map(np.asarray, params)))
    return dict(jm=jm, jv={"params": params}, tm=tm)


def _ref(models, prompt, n):
    return ref_greedy(models["jm"], models["jv"], prompt, n)


def _port(models, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_len", 16)
    return ServeEngine(models["tm"], device="cpu", **kw)


def _jax(models, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_len", 16)
    return JaxServeEngine(models["jm"], models["jv"], **kw)


def _registries():
    regs = {"jax": JaxRegistry(32, V, rank=4),
            "port": AdapterRegistry(32, V, rank=4)}
    for reg in regs.values():
        reg.register_random("acme", seed=100, scale=0.1)
    return regs


def _merged_ref(models, reg, prompt, n):
    """JAX `generate` over the head with ``acme``'s LoRA merged in."""
    from pddl_tpu.ops.lora import merge_lora_into_head

    ad = reg.get("acme")
    merged = {"params": merge_lora_into_head(models["jv"]["params"], ad.a,
                                             ad.b)}
    return ref_greedy(models["jm"], merged, prompt, n)


def _by_prompt(handles):
    return {tuple(int(t) for t in h.request.prompt): h for h in handles}


# ------------------------------------------- the JAX tests, on the port
def test_sigterm_drain_restore_roundtrip(models, tmp_path):
    """SIGTERM → flag → drain at the next step boundary (snapshot on disk,
    admission stopped, ``step()`` 0) → a fresh engine restores → every
    in-flight request resumes token-exactly (`test_serve_faults.py:386`)."""
    reqs = [((np.arange(6) * 3 + 2) % 32, 8), ((np.arange(9) + 4) % 32, 7),
            ((np.arange(5) * 7 + 1) % 32, 6), ((np.arange(7) + 11) % 32, 5)]
    path = str(tmp_path / "serve_drain.json")
    eng_a = _port(models)
    eng_a.install_drain_handler(path)
    try:
        handles_a = [eng_a.submit(p, n) for p, n in reqs]
        for _ in range(3):
            eng_a.step()
        assert sum(h.state == RequestState.RUNNING for h in handles_a) == 2
        partial = [list(h.tokens) for h in handles_a]
        assert any(partial)
        signal.raise_signal(signal.SIGTERM)
        assert eng_a.step() == 0
    finally:
        eng_a.uninstall_drain_handler()
    assert eng_a.drained and not eng_a.has_work
    with pytest.raises(RuntimeError, match="drained"):
        eng_a.submit(reqs[0][0], 2)
    assert eng_a.drain() is eng_a.drain()  # idempotent
    eng_b = _port(models)
    restored = eng_b.restore(path)
    eng_b.run(max_steps=200)
    assert len(restored) == 4
    by_prompt = _by_prompt(restored)
    for (p, n), part in zip(reqs, partial):
        h = by_prompt[tuple(int(t) for t in p)]
        assert h.state == RequestState.FINISHED
        assert h.tokens == _ref(models, p, n)
        assert h.tokens[:len(part)] == part
    assert by_prompt[tuple(int(t) for t in reqs[0][0])].ttft_s is not None


def test_kill_point_mid_step_state_still_drainable(models):
    """A kill point aborts ``step()`` like a SIGKILL; the host state
    drains and restores token-exactly (`test_serve_faults.py:426`)."""
    reqs = [((np.arange(8) * 5 + 3) % 32, 7), ((np.arange(6) + 1) % 32, 6),
            ((np.arange(10) * 3 + 9) % 32, 5)]
    plan = FaultPlan(scheduled=[FaultSpec(step=2, site="tick",
                                          kind=FaultKind.KILL)])
    eng_a = _port(models, fault_plan=plan, backoff_sleep=_no_sleep)
    handles = [eng_a.submit(p, n) for p, n in reqs]
    with pytest.raises(KillPoint):
        eng_a.run(max_steps=100)
    assert any(h.tokens for h in handles)
    snapshot = eng_a.drain()
    assert len(snapshot["requests"]) == 3
    eng_b = _port(models)
    restored = eng_b.restore(snapshot)
    eng_b.run(max_steps=200)
    by_prompt = _by_prompt(restored)
    for p, n in reqs:
        h = by_prompt[tuple(int(t) for t in p)]
        assert h.state == RequestState.FINISHED
        assert h.tokens == _ref(models, p, n)


def test_drain_preserves_remaining_deadline_budget(models):
    """The deadline budget spent before the drain stays spent in a
    restoring engine with another clock epoch (`test_serve_faults.py:453`)."""
    clock_a = FakeClock()
    eng_a = _port(models, max_slots=1, clock=clock_a)
    eng_a.submit(np.arange(4) % 32, 30, deadline_s=10.0)
    eng_a.step()
    clock_a.now = 7.0
    snapshot = eng_a.drain()
    clock_b = FakeClock(100.0)
    eng_b = _port(models, max_slots=1, clock=clock_b)
    (restored,) = eng_b.restore(snapshot)
    eng_b.step()
    assert restored.state == RequestState.RUNNING
    clock_b.now += 4.0
    eng_b.step()
    assert restored.state == RequestState.TIMED_OUT


def test_drain_snapshot_roundtrips_priority_and_deadline(models):
    """`test_serve_slo.py:245`: priority and deadline survive at v5."""
    clock_a = FakeClock()
    eng_a = _port(models, max_slots=1, clock=clock_a)
    h_batch = eng_a.submit(np.arange(6) % 32, 4, priority=Priority.BATCH,
                           deadline_s=30.0)
    h_be = eng_a.submit((np.arange(7) + 2) % 32, 3,
                        priority=Priority.BEST_EFFORT)
    eng_a.step()
    clock_a.now = 4.0
    snapshot = eng_a.drain()
    assert snapshot["version"] == drain_io.SNAPSHOT_VERSION == 5
    by_len = {len(e["prompt"]): e for e in snapshot["requests"]}
    assert by_len[6]["priority"] == "batch"
    assert by_len[6]["deadline_s"] == 30.0
    assert by_len[7]["priority"] == "best_effort"
    assert tuple(by_len[6]) == drain_io.ENTRY_KEYS_V5[:-1]
    eng_b = _port(models, max_slots=1)
    restored = eng_b.restore(snapshot)
    by_prompt = _by_prompt(restored)
    assert by_prompt[tuple(h_batch.request.prompt)].request.priority \
        is Priority.BATCH
    assert by_prompt[tuple(h_be.request.prompt)].request.priority \
        is Priority.BEST_EFFORT
    eng_b.run(max_steps=100)
    assert all(h.state == RequestState.FINISHED for h in restored)


def test_v1_snapshot_restores_with_interactive_default(models, tmp_path):
    """`test_serve_slo.py:277`: a v1 snapshot (no ``priority``) restores
    as interactive and resumes token-exactly; version 99 is refused."""
    p, n = ((np.arange(9) * 5 + 1) % 32).tolist(), 6
    ref = _ref(models, p, n)
    v1 = {"version": 1, "drained_unix_s": 0.0, "requests": [{
        "prompt": p, "max_new_tokens": n,
        "sampling": {"temperature": 0.0, "top_k": None, "top_p": None},
        "deadline_s": None, "elapsed_s": 1.5, "tokens": ref[:2],
        "ttft_s": 0.1}]}
    path = tmp_path / "v1_snapshot.json"
    path.write_text(json.dumps(v1))
    eng = _port(models, max_slots=1)
    (restored,) = eng.restore(str(path))
    assert restored.request.priority is Priority.INTERACTIVE
    eng.run(max_steps=100)
    assert restored.state == RequestState.FINISHED
    assert restored.tokens == ref
    bad = tmp_path / "v99.json"
    bad.write_text(json.dumps({"version": 99, "requests": []}))
    for load in (drain_io.load_snapshot, jax_drain.load_snapshot):
        with pytest.raises(ValueError, match="version"):
            load(str(bad))


def test_kill_mid_verify_drain_restore_token_exact(models):
    """`test_serve_spec.py:403`: a kill at the verify site, then drain
    and restore into a fresh speculative engine."""
    plan = FaultPlan(scheduled=[FaultSpec(step=4, site="verify",
                                          kind=FaultKind.KILL)],
                     sleep_fn=_no_sleep)
    eng = _port(models, spec_k=3, fault_plan=plan, backoff_sleep=_no_sleep)
    handles = [eng.submit(p, n) for p, n in _WORKLOAD[:3]]
    with pytest.raises(KillPoint):
        eng.run(max_steps=300)
    snapshot = eng.drain()
    assert snapshot["version"] == 5
    eng2 = _port(models, spec_k=3)
    restored = eng2.restore(snapshot)
    eng2.run(max_steps=300)
    finished = {(tuple(h.request.prompt), h.request.max_new_tokens): h
                for h in [*handles, *restored] if h.done}
    for p, n in _WORKLOAD[:3]:
        h = finished[(tuple(int(t) for t in p), n)]
        assert h.tokens == _ref(models, p, n)


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_drain_restore_v5_round_trip(models, paged):
    """`test_serve_spec.py:454`: the v5 snapshot carries the draft
    accounting; restore is token-exact into ``spec_k`` 3 and 0."""
    eng = _port(models, spec_k=3, paged=paged)
    handles = [eng.submit(p, n) for p, n in _WORKLOAD[:3]]
    eng.step()
    assert not any(h.done for h in handles)
    snapshot = eng.drain()
    assert snapshot["spec_k"] == 3 and snapshot["paged"] is paged
    entries = snapshot["requests"]
    assert len(entries) == 3 and all("spec" in e for e in entries)
    assert sum(e["spec"]["drafted"] for e in entries) \
        == eng.metrics.spec_drafted_tokens
    for spec_k in (3, 0):
        eng2 = _port(models, spec_k=spec_k, paged=paged)
        restored = eng2.restore(snapshot)
        eng2.run(max_steps=300)
        done = {(tuple(h.request.prompt), h.request.max_new_tokens): h
                for h in restored}
        for p, n in _WORKLOAD[:3]:
            assert done[(tuple(int(t) for t in p), n)].tokens \
                == _ref(models, p, n), spec_k
        if spec_k:
            assert sum(h.spec_drafted for h in restored) \
                >= sum(e["spec"]["drafted"] for e in entries)


def test_v1_through_v4_snapshots_restore_into_spec_engine(models,
                                                          tmp_path):
    """`test_serve_spec.py:489`: pre-speculative entries restore with
    zero draft accounting, token-exactly; future versions are refused."""
    p, n = _WORKLOAD[0]
    ref = _ref(models, p, n)
    for version in (1, 4):
        entry = {"prompt": [int(t) for t in p], "max_new_tokens": n,
                 "tokens": ref[:2], "elapsed_s": 0.5}
        if version == 4:
            entry.update({"sampling": {"temperature": 0.0},
                          "priority": "interactive", "adapter": None,
                          "constraint": None, "ttft_s": 0.01,
                          "deadline_s": None})
        path = tmp_path / f"v{version}.json"
        path.write_text(json.dumps({"version": version,
                                    "requests": [entry]}))
        eng = _port(models, spec_k=3)
        restored = eng.restore(str(path))
        assert restored[0].spec_drafted == 0
        eng.run(max_steps=200)
        assert restored[0].tokens == ref, f"v{version} diverged"
    bad = tmp_path / "future.json"
    bad.write_text(json.dumps({"version": 99, "requests": []}))
    with pytest.raises(ValueError, match="unsupported"):
        drain_io.load_snapshot(str(bad))


def test_paged_drain_restore_round_trip(models):
    """`test_serve_paged.py:413`: the paged snapshot carries each running
    slot's block table; it restores token-exactly, and so does its
    v2-shaped twin (no tables, no ``paged``)."""
    eng1 = _port(models, paged=True)
    p1 = (np.arange(11) * 5 + 2) % 32
    p2 = (np.arange(9) * 7 + 3) % 32
    eng1.submit(p1, 8)
    eng1.submit(p2, 8)
    for _ in range(3):
        eng1.step()
    snap = eng1.drain()
    assert snap["version"] == 5 and snap["paged"] is True
    running = [e for e in snap["requests"] if e.get("tokens")]
    assert running and all("block_table" in e for e in running)
    assert all(0 not in e["block_table"] for e in running)
    snap_v2 = dict(snap, version=2)
    snap_v2.pop("paged")
    snap_v2["requests"] = [{k: v for k, v in e.items() if k != "block_table"}
                           for e in snap["requests"]]
    for source in (snap, snap_v2):
        eng2 = _port(models, paged=True)
        rh = eng2.restore(source)
        eng2.run(max_steps=300)
        assert rh[0].tokens == _ref(models, p1, 8)
        assert rh[1].tokens == _ref(models, p2, 8)


def _tenant_port(models, reg, **kw):
    return _port(models, tenant=TenantConfig(registry=reg,
                                             token_strings=VOCAB32), **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_drain_restore_v4_round_trip(models, paged):
    """`test_serve_tenant.py:516`: adapter and constraint survive; the
    adapter stream resumes on the merged weights, the constrained one
    under the same automaton."""
    reg = _registries()
    spec = {"kind": "regex", "pattern": "[0-9]" * 8}
    eng1 = _tenant_port(models, reg["port"], paged=paged)
    p1 = (np.arange(11) * 5 + 2) % 32
    p2 = (np.arange(9) * 7 + 3) % 32
    eng1.submit(p1, 8, adapter="acme")
    eng1.submit(p2, 8, constraint=spec)
    for _ in range(3):
        eng1.step()
    snap = eng1.drain()
    entries = {len(e["prompt"]): e for e in snap["requests"]}
    assert entries[11]["adapter"] == "acme"
    assert entries[9]["constraint"] == spec
    eng2 = _tenant_port(models, reg["port"], paged=paged)
    rh = eng2.restore(snap)
    eng2.run(max_steps=400)
    assert rh[0].tokens == _merged_ref(models, reg["jax"], p1, 8)
    fsm = compile_constraint(spec, VOCAB32)
    assert fsm.accepts(rh[1].tokens) or len(rh[1].tokens) == 8


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_old_snapshots_restore_with_tenant_defaults(models, tmp_path,
                                                    paged):
    """`test_serve_tenant.py:549`: v1-v3 entries restore into a tenant
    engine as "no adapter, unconstrained", token-exactly."""
    reg = _registries()["port"]
    p, n = ((np.arange(9) * 5 + 1) % 32).tolist(), 6
    ref = _ref(models, p, n)
    for version in (1, 2, 3):
        entry = {"prompt": p, "max_new_tokens": n,
                 "sampling": {"temperature": 0.0, "top_k": None,
                              "top_p": None},
                 "deadline_s": None, "elapsed_s": 1.5, "tokens": ref[:2],
                 "ttft_s": 0.1}
        if version >= 2:
            entry["priority"] = "interactive"
        snap = {"version": version, "drained_unix_s": 0.0,
                "requests": [entry]}
        if version >= 3:
            snap["paged"] = False
        path = tmp_path / f"v{version}.json"
        path.write_text(json.dumps(snap))
        eng = _tenant_port(models, reg, max_slots=1, paged=paged)
        (restored,) = eng.restore(str(path))
        assert restored.request.adapter is None
        assert restored.request.constraint is None
        eng.run(max_steps=200)
        assert restored.tokens == ref, (version, paged)


def test_plain_engine_refuses_tenant_snapshot(models):
    """`test_serve_tenant.py:589`, in the JAX engine's words."""
    reg = _registries()
    eng1 = _tenant_port(models, reg["port"], max_slots=1)
    eng1.submit((np.arange(8) * 3 + 1) % 32, 6, adapter="acme")
    eng1.step()
    snap = eng1.drain()
    errors = []
    for plain in (_port(models, max_slots=1), _jax(models, max_slots=1)):
        with pytest.raises(ValueError, match="tenant") as info:
            plain.restore(snap)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def _tier_kw(paged):
    return dict(max_slots=2, prefill_len=32, prefix_block_size=8,
                prefix_chunk=8, host_tier=1 << 24, paged=paged,
                prefix_cache_blocks=2 * (MAX_LEN // 8) + 2 if paged else 8)


def _tier_prompts(n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, V, size=24).astype(np.int32) for _ in range(n)]


def _serve_all(eng, prompts, n_new):
    for p in prompts:
        h = eng.submit(p, n_new)
        eng.run(max_steps=5000)
        assert h.done


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_kill_mid_promotion_drain_restores_token_exact(models, paged):
    """`test_kv_tier.py:421`: a kill at ``host_promote`` with the tier
    populated; the snapshot restores into a fresh tiered engine."""
    prompts = _tier_prompts(6)
    plan = FaultPlan(scheduled=[
        FaultSpec(step=s, site="host_promote", kind=FaultKind.KILL)
        for s in range(200)])
    eng = _port(models, fault_plan=plan, backoff_sleep=_no_sleep,
                **_tier_kw(paged))
    _serve_all(eng, prompts, 6)
    assert eng.metrics.host_tier_spills > 0
    handles = [eng.submit(p, 6) for p in prompts]
    with pytest.raises(KillPoint):
        for _ in range(2000):
            if all(h.done for h in handles):
                break
            eng.step()
    fresh = _port(models, **_tier_kw(paged))
    restored = fresh.restore(eng.drain())
    fresh.run(max_steps=5000)
    assert all(h.done for h in restored)
    by_prompt = _by_prompt(restored)
    for p in prompts:
        assert by_prompt[tuple(int(t) for t in p)].tokens \
            == _ref(models, p, 6)


def test_drain_restore_with_tier_populated(models):
    """`test_kv_tier.py:461`: a graceful drain with chains in the tier."""
    prompts = _tier_prompts(4)
    eng = _port(models, **_tier_kw(False))
    _serve_all(eng, prompts, 8)
    assert eng.metrics.host_tier_spills > 0
    for p in prompts:
        eng.submit(p, 8)
    for _ in range(3):
        eng.step()
    fresh = _port(models, **_tier_kw(False))
    restored = fresh.restore(eng.drain())
    fresh.run(max_steps=5000)
    assert all(h.state is RequestState.FINISHED for h in restored)
    by_prompt = _by_prompt(restored)
    for p in prompts:
        assert by_prompt[tuple(int(t) for t in p)].tokens \
            == _ref(models, p, 8)


# ------------------------------------------------- across the packages
def _engines(models, name, **kw):
    """One package's engine under its own fake clock."""
    clock = FakeClock()
    kw = dict(kw)
    if "tenant" in kw:
        reg = kw.pop("tenant")[name]
        cfg = JaxTenantConfig if name == "jax" else TenantConfig
        kw["tenant"] = cfg(registry=reg, token_strings=VOCAB32)
    if "host_tier" in kw and name == "jax":
        kw["host_tier"] = JaxHostTierConfig(byte_budget=kw["host_tier"])
    build = _jax if name == "jax" else _port
    return build(models, clock=clock, **kw), clock


def _drained_wave(models, name, steps=3, **kw):
    """The workload (plus a deadline and a best-effort class) on one
    package's engine, a fake second a step, drained after ``steps``."""
    eng, clock = _engines(models, name, **kw)
    for i, (p, n) in enumerate(_WORKLOAD):
        eng.submit(p, n, deadline_s=60.0 if i == 1 else None,
                   priority="best_effort" if i == 3 else "interactive")
    for _ in range(steps):
        eng.step()
        clock.now += 1.0
    return eng.drain()


def _wall_free(snapshot):
    """The snapshot without its wall-clock fields: ``drained_unix_s`` and
    the telemetry's per-site wall times (the fake clock makes the rest
    deterministic)."""
    out = json.loads(json.dumps(snapshot))
    out.pop("drained_unix_s")
    out["telemetry"].pop("site_wall_s", None)
    return out


LEGS = {"row": {}, "paged": dict(paged=True),
        "spec_paged": dict(paged=True, spec_k=3),
        "tenant_row": "tenant"}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_snapshot_json_equals_jax_field_by_field(models, leg):
    kw = LEGS[leg]
    submit_kw = {}
    if kw == "tenant":
        kw = dict(tenant=_registries())
        submit_kw = {0: {"adapter": "acme"},
                     1: {"constraint": {"kind": "regex",
                                        "pattern": "[0-9]+"}}}
    snaps = {}
    for name in ("jax", "port"):
        eng, clock = _engines(models, name, **kw)
        for i, (p, n) in enumerate(_WORKLOAD):
            eng.submit(p, n, **submit_kw.get(i, {}))
        for _ in range(3):
            eng.step()
            clock.now += 1.0
        snaps[name] = eng.drain()
    ours, ref = _wall_free(snaps["port"]), _wall_free(snaps["jax"])
    assert list(snaps["port"]) == list(snaps["jax"])  # key order too
    for key in ref:
        assert ours[key] == ref[key], key
    for entry_p, entry_j in zip(snaps["port"]["requests"],
                                snaps["jax"]["requests"]):
        assert json.dumps(entry_p) == json.dumps(entry_j)
    assert set(snaps["port"]["telemetry"]["site_wall_s"]) \
        == set(snaps["jax"]["telemetry"]["site_wall_s"])


@pytest.mark.parametrize("source,paged", [
    ("jax", False), ("jax", True), ("port", False), ("port", True)])
def test_cross_package_round_trip(models, source, paged):
    """A snapshot one package drains, written to JSON and back, restores
    into the other package's engine, and every stream finishes as the
    JAX engine's own restore of it does, token for token."""
    snapshot = json.loads(json.dumps(
        _drained_wave(models, source, paged=paged)))
    target = "port" if source == "jax" else "jax"
    streams = {}
    for name in (target, "jax") if target == "port" else ("jax",):
        eng, _ = _engines(models, name, paged=paged)
        restored = eng.restore(snapshot)
        eng.run(max_steps=300)
        assert all(h.done for h in restored)
        streams[name] = [list(h.tokens) for h in restored]
    if target == "jax":
        eng, _ = _engines(models, "port", paged=paged)
        restored = eng.restore(snapshot)
        eng.run(max_steps=300)
        streams["port"] = [list(h.tokens) for h in restored]
    assert streams["port"] == streams["jax"]
    for entry, stream in zip(snapshot["requests"], streams["port"]):
        assert stream[:len(entry["tokens"])] == entry["tokens"]
        assert stream == _ref(models, entry["prompt"],
                              entry["max_new_tokens"])


def test_cross_process_drain_child_restores_into_the_port(tmp_path):
    """`tests/_serve_drain_child.py` (the JAX package's seeded fleet-worker
    engine, in its own interpreter) serves and drains to disk; the port's
    engine, on the same seeded weights bridged, restores the snapshot and
    every stream equals the JAX engine's continuation of it, token for
    token, and resumes the child's partial stream."""
    from pddl_tpu.serve.fleet.worker import build_engine

    workload = [
        {"prompt": ((np.arange(10) * 5 + 1) % 64).tolist(),
         "max_new_tokens": 8},
        {"prompt": ((np.arange(13) * 3 + 7) % 64).tolist(),
         "max_new_tokens": 7},
        {"prompt": ((np.arange(7) + 17) % 64).tolist(),
         "max_new_tokens": 6},
        {"prompt": ((np.arange(11) * 7 + 2) % 64).tolist(),
         "max_new_tokens": 5},
    ]
    cfg = dict(vocab=64, max_len=128, embed_dim=64, depth=2, heads=2,
               slots=2, prefill_len=32, max_queue_depth=64, param_seed=3,
               steps_before_drain=3, workload=workload)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(here) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "_serve_drain_child.py"),
         str(tmp_path), json.dumps(cfg)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "state.json") as f:
        child = json.load(f)
    assert any(child["partial_tokens"]) and "running" in child["states"]
    path = str(tmp_path / "snapshot.json")

    jeng = build_engine(cfg)
    jax_restored = jeng.restore(path)
    jeng.run(max_steps=500)
    model = GPT(vocab_size=64, max_len=128, embed_dim=64, depth=2,
                num_heads=2, device="cpu")
    model.load_state_dict(gpt_params_from_jax(
        jax.tree.map(np.asarray, jeng._params)))
    eng = ServeEngine(model, device="cpu", max_slots=2, prefill_len=32,
                      max_queue_depth=64)
    restored = eng.restore(path)
    eng.run(max_steps=500)
    assert len(restored) == len(workload)
    ours, ref = _by_prompt(restored), _by_prompt(jax_restored)
    for req, part in zip(workload, child["partial_tokens"]):
        h = ours[tuple(req["prompt"])]
        assert h.state == RequestState.FINISHED
        assert h.tokens == ref[tuple(req["prompt"])].tokens
        assert h.tokens[:len(part)] == part
