"""Sliced prefill (`ServeEngine(prefill_slice_tokens=...)`) in the port's
serving engine against the JAX engine on the CPU, from the same bridged
`tiny_gpt` weights (vocabulary 32, `max_len` 64) and a `FakeClock` each.

Every scenario runs on both engines with the same submits, cancels and
clock moves; at every step the tokens emitted, the live slots and the
queue depth are equal, and so are the streams, their states and the
clock-free metrics:

- the JAX tests `test_serve_slo.py` (a long cold prompt's admission
  interleaves with a running stream's ticks, token-exact; cancel and
  deadline landing mid-slice), `test_serve_paged.py` (paged sliced
  admission; a parked slice dropped by a tick fault's pool reset and
  admitted again) and `test_serve_tenant.py` (an install fault after a
  one-step slice releasing the adapter pin once), each in the modes named;
- the draft model's tree advancing with each slice (paged, `spec_k=3`),
  the n-gram drafter beside a slice (row), the host tier's promotion
  ahead of a sliced row admission's gather, and preemption and the tenant
  admit across a parked slice;
- the refusals in the JAX engine's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import FakeClock, ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.serve import FaultPlan as JaxFaultPlan
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.faults import FaultKind as JaxFaultKind
from pddl_tpu.serve.request import Priority as JaxPriority
from pddl_tpu.serve.tenant import AdapterRegistry as JaxRegistry
from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.models.gpt import tiny_gpt
from pddl_tpu_torch.serve import FaultKind, FaultPlan, Priority, ServeEngine
from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig

V, MAX_LEN = 32, 64
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))
TIMED = ("ttft", "latency", "tokens_per_s")


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


class _Side:
    """One package's engine, its fake clock and its per-step trace."""

    def __init__(self, name, eng, clock, pkg):
        self.name, self.eng, self.clock, self.pkg = name, eng, clock, pkg
        self.trace = []

    def step(self):
        n = self.eng.step()
        self.trace.append((n, self.eng.live_slots, self.eng.scheduler.depth,
                           self.eng._slice is not None))
        return n

    def run(self, max_steps):
        for _ in range(max_steps):
            if not self.eng.has_work:
                return
            self.step()


def _sides(models, *, tenant=False, draft=False, fault_plan=False, **kw):
    """The JAX and the port engine at the same options, each with its own
    fake clock (and fault plan, registry)."""
    out = []
    for name in ("jax", "port"):
        ekw = dict(kw)
        clock = FakeClock()
        if fault_plan:
            plan_cls = JaxFaultPlan if name == "jax" else FaultPlan
            ekw.update(fault_plan=plan_cls(sleep_fn=_no_sleep),
                       backoff_sleep=_no_sleep)
        if tenant:
            reg = (JaxRegistry if name == "jax" else AdapterRegistry)(
                32, V, rank=4)
            for i, ad in enumerate(("acme", "globex")):
                reg.register_random(ad, seed=100 + i, scale=0.1)
            cfg = JaxTenantConfig if name == "jax" else TenantConfig
            ekw["tenant"] = cfg(registry=reg, token_strings=VOCAB32)
        if name == "jax":
            if draft:
                ekw.update(spec_draft_model=models["jd"],
                           spec_draft_variables=models["jdv"])
            eng = JaxServeEngine(models["jm"], models["jv"], clock=clock,
                                 **ekw)
            pkg = dict(kind=JaxFaultKind, prio=JaxPriority)
        else:
            if draft:
                ekw["spec_draft_model"] = models["td"]
            eng = ServeEngine(models["tm"], device="cpu", clock=clock, **ekw)
            pkg = dict(kind=FaultKind, prio=Priority)
        out.append(_Side(name, eng, clock, pkg))
    return out


def _both(models, scenario, **kw):
    """Run ``scenario(side)`` on both engines; assert the per-step traces,
    the returned handles' streams and states and the clock-free metrics
    equal; return the JAX side's result and both sides."""
    sides = _sides(models, **kw)
    results = [scenario(side) for side in sides]
    jax_side, port_side = sides
    assert port_side.trace == jax_side.trace
    for hj, hp in zip(results[0]["handles"], results[1]["handles"]):
        assert hp.tokens == hj.tokens
        assert hp.state.value == hj.state.value
        assert hp.replays == hj.replays
    ours = port_side.eng.metrics.snapshot()
    ref = jax_side.eng.metrics.snapshot()
    for key, val in ours.items():
        if not any(t in key for t in TIMED):
            assert val == ref[key], key
    return results[0], sides


def _interleave(side):
    """`test_serve_slo.py:314`'s scenario: A runs, then a 31-token cold
    prompt B arrives; count B's admission steps and A's tokens meanwhile."""
    eng = side.eng
    short_p, long_p = (np.arange(6) + 1) % 32, (np.arange(31) * 3) % 32
    a = eng.submit(short_p, 12)
    side.step()
    b = eng.submit(long_p, 3)
    a_before, steps = len(a.tokens), 0
    while not b.tokens:
        side.step()
        steps += 1
        assert steps < 50
    a_during = len(a.tokens) - a_before
    side.run(200)
    return dict(handles=[a, b], prompts=[short_p, long_p], news=[12, 3],
                steps=steps, a_during=a_during)


@pytest.mark.parametrize("paged,slice_tokens", [(False, 8), (True, 8),
                                                (False, None)],
                         ids=["row", "paged", "row-whole"])
def test_sliced_prefill_interleaves_decode_ticks(models, paged,
                                                 slice_tokens):
    res, _ = _both(models, _interleave, max_slots=2, prefill_len=32,
                   prefix_chunk=8, prefill_slice_tokens=slice_tokens,
                   paged=paged)
    if slice_tokens is None:
        # Whole-prompt admission lands B in ONE step, A gets one tick.
        assert res["steps"] == 1 and res["a_during"] <= 1
    else:
        # 31 cold tokens at 8 a step: >= 4 steps, A emitting in each.
        assert res["steps"] >= 4 and res["a_during"] >= 3
    for h, p, n in zip(res["handles"], res["prompts"], res["news"]):
        assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)


def _cancel_and_deadline(side):
    """`test_serve_slo.py:357`'s scenario: cancel and a deadline landing
    while a slice is parked, then the same prompt served whole."""
    eng = side.eng
    long_p = (np.arange(31) * 5 + 2) % 32
    h = eng.submit(long_p, 4)
    side.step()
    assert not h.done and not h.tokens and eng._slice is not None
    h.cancel()
    side.step()
    h2 = eng.submit(long_p, 4, deadline_s=1.0)
    side.step()
    side.clock.now += 5.0
    side.step()
    h3 = eng.submit(long_p, 4)
    side.run(100)
    return dict(handles=[h, h2, h3], long_p=long_p)


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_cancel_and_deadline_land_mid_slice(models, paged):
    res, (jax_side, port_side) = _both(
        models, _cancel_and_deadline, max_slots=1, prefill_len=32,
        prefix_chunk=8, prefill_slice_tokens=8, paged=paged)
    h, h2, h3 = res["handles"]
    assert h.state.value == "cancelled"
    assert h2.state.value == "timed_out"
    assert h2.finish_reason.value == "timed_out"
    assert h3.tokens == ref_greedy(models["jm"], models["jv"],
                                   res["long_p"], 4)
    snap = port_side.eng.metrics.snapshot()
    assert snap["requests_cancelled"] == 1
    assert snap["requests_timed_out"] == 1
    if paged:
        # The cancelled and expired slices handed their blocks back.
        eng = port_side.eng
        assert eng._prefix.blocks_live <= eng._prefix.num_blocks - 1


def _same_prompt_twice(side):
    """`test_serve_paged.py:325`: two equal 15-token prompts, sliced at 4
    tokens a step into the pool."""
    p = (np.arange(15) * 3 + 1) % 32
    handles = [side.eng.submit(p, 6), side.eng.submit(p, 6)]
    side.run(300)
    return dict(handles=handles, p=p)


def test_paged_sliced_admission_token_exact(models):
    res, _ = _both(models, _same_prompt_twice, max_slots=2, prefill_len=16,
                   paged=True, prefill_slice_tokens=4, prefix_chunk=4)
    want = ref_greedy(models["jm"], models["jv"], res["p"], 6)
    assert [h.tokens for h in res["handles"]] == [want, want]


def _slice_through_pool_reset(side):
    """`test_serve_paged.py:377`: a slice parked mid-prefill when a tick
    exhausts its retries and resets the paged pool: the slice is dropped
    without releasing its retired ids and admitted again from scratch."""
    eng = side.eng
    p_live = (np.arange(8) * 5 + 4) % 32
    p_sliced = (np.arange(15) * 3 + 1) % 32
    h_live = eng.submit(p_live, 8)
    while eng.live_slots < 1:
        side.step()
    h_sliced = eng.submit(p_sliced, 4)
    side.step()
    assert eng._slice is not None
    eng._faults._sched[(eng._step_idx, "tick")] = [
        side.pkg["kind"].TRANSIENT]
    side.run(400)
    return dict(handles=[h_live, h_sliced], prompts=[p_live, p_sliced],
                news=[8, 4])


def test_parked_slice_survives_paged_pool_reset(models):
    res, (_, port_side) = _both(
        models, _slice_through_pool_reset, max_slots=2, prefill_len=16,
        paged=True, prefill_slice_tokens=4, prefix_chunk=4, fault_plan=True,
        max_retries=0)
    for h, p, n in zip(res["handles"], res["prompts"], res["news"]):
        assert h.done
        assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
    assert port_side.eng.metrics.replays >= 1


def _install_fault_after_one_step_slice(side):
    """`test_serve_tenant.py:444`: a slice that completes in its first
    step, then a transient at ``sample_first`` with no retry left."""
    eng = side.eng
    p = (np.arange(8) * 5 + 1) % 32
    h = eng.submit(p, 4, adapter="acme")
    eng._faults._sched[(eng._step_idx, "sample_first")] = [
        side.pkg["kind"].TRANSIENT]
    side.run(100)
    return dict(handles=[h])


def test_install_fault_after_single_step_slice_releases_pin_once(models):
    res, (jax_side, port_side) = _both(
        models, _install_fault_after_one_step_slice, tenant=True,
        max_slots=1, prefill_len=16, prefill_slice_tokens=16,
        prefix_chunk=4, fault_plan=True, max_retries=0)
    (h,) = res["handles"]
    assert h.state.value == "finished" and h.replays >= 1
    assert port_side.eng._apool.pinned_rows() == []
    assert jax_side.eng._apool.pinned_rows() == []


def _running_then_cold(side):
    """Two repetitive streams run; a 31-token cold prompt is sliced in
    beside them."""
    eng = side.eng
    prompts = [np.tile([3, 1, 4, 1], 4) % 32, (np.arange(31) * 7 + 2) % 32,
               np.tile([5, 9, 2], 5) % 32]
    news = [20, 6, 12]
    handles = [eng.submit(prompts[0], news[0])]
    side.step()
    handles.append(eng.submit(prompts[1], news[1]))
    handles.append(eng.submit(prompts[2], news[2]))
    side.run(300)
    return dict(handles=handles, prompts=prompts, news=news)


@pytest.mark.parametrize("leg", ["draft_paged", "ngram_row"])
def test_sliced_prefill_beside_speculation(models, leg):
    """The draft model's tree advances chunk for chunk with each slice
    (the ``draft_prefill`` site at the target's offsets and blocks); the
    n-gram drafter's history is stamped at the slice's install."""
    kw = dict(max_slots=2, prefill_len=32, prefix_chunk=8,
              prefill_slice_tokens=8, spec_k=3)
    if leg == "draft_paged":
        kw.update(paged=True, draft=True)
    res, (_, port_side) = _both(models, _running_then_cold, **kw)
    for h, p, n in zip(res["handles"], res["prompts"], res["news"]):
        assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
    assert any(t[3] for t in port_side.trace)  # a slice parked


def _tier_cycle(side):
    """Distinct 24-token prompts cycled through a tiny pool (demotions),
    then served again (promotions ahead of each sliced admission)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, size=24).astype(np.int32)
               for _ in range(6)]
    handles = []
    for _ in range(2):
        for p in prompts:
            handles.append(side.eng.submit(p, 4))
            side.run(500)
    return dict(handles=handles, prompts=prompts * 2, news=[4] * 12)


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_sliced_admission_promotes_from_the_host_tier(models, paged):
    res, (_, port_side) = _both(
        models, _tier_cycle, max_slots=2, prefill_len=32,
        prefix_block_size=8, prefix_chunk=8, prefill_slice_tokens=8,
        prefix_cache_blocks=2 * (MAX_LEN // 8) + 2 if paged else 8,
        host_tier=1 << 24, paged=paged)
    snap = port_side.eng.metrics.snapshot()
    assert snap["host_tier_spills"] > 0 and snap["host_tier_promotions"] > 0
    for h, p, n in zip(res["handles"], res["prompts"], res["news"]):
        assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)


def _preempt_and_tenant_across_a_slice(side):
    """Best-effort adapter streams fill both slots; an interactive
    constrained request with a long prompt preempts one and is sliced in;
    another request queues behind the parked slice."""
    eng, prio = side.eng, side.pkg["prio"]
    spec = {"kind": "regex", "pattern": "[0-9]+"}
    be = [eng.submit((np.arange(7) + i) % 32, 12, adapter="acme",
                     priority=prio.BEST_EFFORT) for i in range(2)]
    side.step()
    ia = eng.submit((np.arange(29) * 3 + 1) % 32, 6, constraint=spec,
                    priority=prio.INTERACTIVE)
    late = eng.submit((np.arange(9) * 5 + 2) % 32, 5, adapter="globex")
    side.run(400)
    return dict(handles=be + [ia, late])


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_preemption_and_tenant_admit_across_a_parked_slice(models, paged):
    res, (jax_side, port_side) = _both(
        models, _preempt_and_tenant_across_a_slice, tenant=True,
        max_slots=2, prefill_len=32, prefix_chunk=8, prefill_slice_tokens=8,
        paged=paged)
    assert port_side.eng.metrics.preemptions >= 1
    assert all(h.done for h in res["handles"])
    assert port_side.eng._apool.pinned_rows() == []


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_slice_tokens=8, prefix_cache_blocks=0),
     "requires the prefix-cache engine"),
    (dict(prefill_slice_tokens=0), "must be >= 1"),
])
def test_slice_refusals_match_jax(models, kw, match):
    errors = []
    for build in (lambda: JaxServeEngine(models["jm"], models["jv"],
                                         max_slots=2, prefill_len=16, **kw),
                  lambda: ServeEngine(models["tm"], device="cpu",
                                      max_slots=2, prefill_len=16, **kw)):
        with pytest.raises(ValueError, match=match) as info:
            build()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
