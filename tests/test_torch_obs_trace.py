"""Per-request tracing in the port (`pddl_tpu_torch/obs/trace.py`,
`ServeEngine(tracer=...)`/`set_tracer`) against the JAX package's on the
CPU, from the same bridged `tiny_gpt` weights (vocabulary 32, `max_len`
64).

- The JAX tests `test_obs.py` on the port: the disabled tracer allocates
  nothing over an engine run, nor through its fleet hooks (`tracemalloc`
  over the port's module); a span reconstructs the request's timeline and
  round-trips through the JAX package's JSONL sink; a broken sink never
  crashes the engine; a drain flushes the in-flight spans; the event caps;
  the hook surface (`RequestTracer`'s hooks are `NullTracer`'s, and the
  port's `NullTracer` is the JAX one's, signature for signature).
- `test_serve_faults.py`'s scheduled fault surfaces in the trace at its
  exact `(step, site)`, and a replay's admission waits from its requeue.
- Every case runs on both engines under fake clocks, and the span records
  and engine events are equal, wall times (`wall_s`) left out; a mixed
  run (seeded faults, OOM and re-arm, preemption, a cancel, a queued
  deadline shed, sliced prefill, a drain and a traced restore) holds all
  31 hook sites to the JAX engine's, in both modes. No hook receives a
  tensor.
"""

import inspect
import json
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.obs.trace as jax_trace
import pddl_tpu_torch.obs.trace as trace_mod
from conftest import FakeClock, ref_greedy
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.obs.export import JsonlEventLog, read_jsonl
from pddl_tpu.serve import FaultPlan as JaxFaultPlan
from pddl_tpu.serve import ServeEngine as JaxServeEngine
from pddl_tpu.serve.faults import FaultKind as JaxFaultKind
from pddl_tpu.serve.faults import FaultSpec as JaxFaultSpec
from pddl_tpu_torch.bridge import gpt_params_from_jax
from pddl_tpu_torch.models.gpt import tiny_gpt
from pddl_tpu_torch.obs import NULL_TRACER, NullTracer, RequestTracer
from pddl_tpu_torch.serve import FaultKind, FaultPlan, FaultSpec, ServeEngine
from pddl_tpu_torch.serve.request import RequestHandle

V, MAX_LEN = 32, 64


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


def _engine(models, name, tracer=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_len", 16)
    if name == "jax":
        return JaxServeEngine(models["jm"], models["jv"], tracer=tracer, **kw)
    return ServeEngine(models["tm"], device="cpu", tracer=tracer, **kw)


def _tracer(name, **kw):
    return (jax_trace.RequestTracer if name == "jax" else RequestTracer)(
        **kw)


def _strip(record, ids=None):
    """A record with its wall times (``wall_s``, from ``perf_counter``
    around a call) left out, everywhere in it. With ``ids``, request ids
    (and the trace ids made from them) become their order of first
    appearance: each package numbers its requests from its own counter."""
    if isinstance(record, dict):
        out = {}
        for k, v in record.items():
            if k == "wall_s":
                continue
            if ids is not None and k == "request_id":
                v = ids.setdefault(v, len(ids))
            elif ids is not None and k == "trace_id":
                v = ids.setdefault(int(v, 16), len(ids))
            out[k] = _strip(v, ids)
        return out
    if isinstance(record, list):
        return [_strip(v, ids) for v in record]
    return record


def _assert_same_trace(tracers):
    seen = {"jax": {}, "port": {}}
    for attr in ("finished", "engine_events"):
        ours, ref = (_strip(list(getattr(tracers[name], attr)), seen[name])
                     for name in ("port", "jax"))
        assert ours == ref, attr
    for attr in ("spans_started", "spans_finished", "sink_errors"):
        assert getattr(tracers["port"], attr) == getattr(tracers["jax"], attr)


def _both(models, drive, tracer_kw=None, **engine_kw):
    """``drive(eng, clock)`` on both engines, each with its own fake clock
    and a tracer on it; the traces compared. Returns the tracers, the
    engines and what ``drive`` returned."""
    tracers, engines, out = {}, {}, {}
    for name in ("jax", "port"):
        clock = FakeClock()
        tracers[name] = _tracer(name, clock=clock, **(tracer_kw or {}))
        engines[name] = _engine(models, name, tracer=tracers[name],
                                clock=clock, **engine_kw)
        out[name] = drive(engines[name], clock)
    _assert_same_trace(tracers)
    return tracers, engines, out


# ----------------------------------------------------- the zero-cost pins
def _grew(snap_before, snap_after, path):
    diff = snap_after.filter_traces([tracemalloc.Filter(True, path)]) \
        .compare_to(snap_before.filter_traces(
            [tracemalloc.Filter(True, path)]), "lineno")
    return [d for d in diff if d.size_diff > 0]


def test_disabled_tracer_allocates_nothing(models):
    """`test_obs.py:66`: a full engine run with the default no-op tracer
    allocates nothing attributed to the port's `obs/trace.py`."""
    eng = _engine(models, "port")
    assert eng.tracer is trace_mod.NULL_TRACER is NULL_TRACER
    handles = [eng.submit((np.arange(5) + i) % 32, 4) for i in range(3)]
    eng.run(max_steps=5)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        eng.run(max_steps=200)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert all(h.done for h in handles)
    grew = _grew(before, after, trace_mod.__file__)
    assert not grew, f"disabled tracer allocated: {grew}"


def test_disabled_tracer_dtrace_hooks_allocate_nothing():
    """`test_obs.py:131`: the fleet and distributed-tracing hooks of the
    port's no-op tracer allocate nothing either."""
    tracer = trace_mod.NULL_TRACER

    def drive():
        for i in range(200):
            tracer.on_trace_context(i, "0" * 16, "router")
            tracer.on_restored(None, i)
            tracer.on_chain_export(3, 0.001)
            tracer.on_chain_import(3, 0.001)
            tracer.on_span_shipped(4, 0)
            tracer.on_flight_rotate(2, 4096)

    drive()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        drive()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grew = _grew(before, after, trace_mod.__file__)
    assert not grew, f"disabled dtrace hooks allocated: {grew}"


def test_hook_surface_matches_null_and_the_jax_tracer():
    """`test_obs.py:520`: `RequestTracer` overrides only hooks
    `NullTracer` declares; and the port's surface IS the JAX one, name
    and signature, so one tracer class serves both engines."""
    null_hooks = {n for n in vars(NullTracer) if n.startswith("on_")}
    real_hooks = {n for n in vars(RequestTracer) if n.startswith("on_")}
    assert real_hooks <= null_hooks, real_hooks - null_hooks
    jax_hooks = {n for n in vars(jax_trace.NullTracer) if n.startswith("on_")}
    assert null_hooks == jax_hooks
    for name in null_hooks:
        assert inspect.signature(getattr(NullTracer, name)) \
            == inspect.signature(getattr(jax_trace.NullTracer, name)), name
    assert trace_mod.SCHEMA_VERSION == jax_trace.SCHEMA_VERSION


# ---------------------------------------------------------- span records
def test_span_timeline_reconstructs_request(models, tmp_path):
    """`test_obs.py:175`: one traced request's span holds queue →
    admission → prefix match → prefill chunks → first token → decode →
    finish with monotone times, and the JSONL sink holds the same record;
    the JAX tracer records the same span."""
    p, n = (np.arange(10) * 3 + 1) % 32, 5
    path = str(tmp_path / "trace.jsonl")
    log = JsonlEventLog(path)

    def drive(eng, clock):
        h = eng.submit(p, n)
        for _ in range(50):
            if not eng.has_work:
                break
            eng.step()
            clock.now += 0.25
        return h

    tracers = {}
    for name in ("jax", "port"):
        clock = FakeClock()
        tracers[name] = _tracer(name, clock=clock,
                                sink=log if name == "port" else None)
        eng = _engine(models, name, tracer=tracers[name], clock=clock)
        h = drive(eng, clock)
        assert h.tokens == ref_greedy(models["jm"], models["jv"], p, n)
    log.close()
    _assert_same_trace(tracers)
    tracer = tracers["port"]
    assert tracer.spans_finished == 1
    (record,) = list(tracer.finished)
    assert record["kind"] == "span" and record["schema"] == 1
    assert record["finish_reason"] == "length"
    assert record["attrs"]["prompt_len"] == 10
    assert record["attrs"]["tokens_emitted"] == n
    assert record["attrs"]["ttft_s"] >= 0
    names = [e["name"] for e in record["events"]]
    assert names[0] == "queued"
    for name in ("admitted", "prefix_match", "prefill_chunk", "first_token"):
        assert name in names
    assert names.count("decode") == n - 1
    ts = [e["t_s"] for e in record["events"]]
    assert ts == sorted(ts)
    assert record["end_s"] >= record["start_s"]
    chunks = [e for e in record["events"] if e["name"] == "prefill_chunk"]
    assert all(c["wall_s"] > 0 for c in chunks)
    (from_disk,) = [r for r in read_jsonl(path) if r["kind"] == "span"]
    assert from_disk == json.loads(json.dumps(record))


def test_broken_sink_never_crashes_the_engine(models):
    """`test_obs.py:197`: a sink that starts failing mid-run degrades to
    counted no-export; the engine serves on and drains cleanly."""
    def drive(eng, clock):
        h1 = eng.submit(np.arange(5) % 32, 3)
        eng.run(max_steps=30)
        broken[0] = True
        h2 = eng.submit((np.arange(6) + 1) % 32, 3)
        eng.run(max_steps=30)
        assert h1.done and h2.done
        assert eng.drain()["telemetry"]["ticks"] > 0
        broken[0] = False

    def sink(record):
        if broken[0]:
            raise OSError("sink closed")
        written.append(record)

    broken, written = [False], []
    tracers = {}
    for name in ("jax", "port"):
        clock = FakeClock()
        tracers[name] = _tracer(name, clock=clock, sink=sink)
        drive(_engine(models, name, tracer=tracers[name], max_slots=1,
                      clock=clock), clock)
    _assert_same_trace(tracers)
    assert tracers["port"].sink_errors > 0
    assert tracers["port"].spans_finished == 2
    assert _strip(written[:len(written) // 2], {}) \
        == _strip(written[len(written) // 2:], {})


def test_drain_flushes_inflight_spans(models):
    """`test_obs.py:227`: the drain flushes every in-flight span with
    ``finish_reason="drained"``, the running one's history intact."""
    def drive(eng, clock):
        running = eng.submit(np.arange(5) % 32, 20)
        queued = eng.submit((np.arange(6) + 1) % 32, 4)
        for _ in range(3):
            eng.step()
        assert not running.done and not queued.done
        eng.drain()
        return running

    tracers, _, out = _both(models, drive, max_slots=1)
    tracer = tracers["port"]
    assert not tracer.active
    spans = list(tracer.finished)
    assert len(spans) == 2
    assert all(s["finish_reason"] == "drained" for s in spans)
    assert all(s["attrs"]["drained"] for s in spans)
    run_span = {s["request_id"]: s for s in spans}[
        out["port"].request.request_id]
    names = [e["name"] for e in run_span["events"]]
    assert "admitted" in names and "decode" in names
    assert tracer.events_named("drain")[0]["n_requests"] == 2


@pytest.mark.parametrize("cap,decode_cap", [(4, 512), (4096, 2)],
                         ids=["events", "decode_events"])
def test_span_event_caps_drop_and_count(models, cap, decode_cap):
    """`test_obs.py:240` and the next test: past ``max_events_per_span``
    events are counted, not stored; decode events stop at their own cap
    while the finish still lands."""
    def drive(eng, clock):
        h = eng.submit(np.arange(6) % 32, 10)
        eng.run(max_steps=50)
        assert h.done

    tracers, _, _ = _both(models, drive, max_slots=1, tracer_kw=dict(
        max_events_per_span=cap, max_decode_events_per_span=decode_cap))
    (record,) = list(tracers["port"].finished)
    if cap == 4:
        assert len(record["events"]) == 4 and record["events_dropped"] > 0
    else:
        names = [e["name"] for e in record["events"]]
        assert names.count("decode") == 2
        assert record["events_dropped"] == 10 - 1 - 2
        assert record["finish_reason"] == "length"


def test_scheduled_fault_surfaces_in_trace_at_exact_coordinates(models):
    """`test_serve_faults.py:175`: two transients at (step 2, tick) give
    two ``fault_injected`` and two ``retry`` events at that coordinate,
    attempts 1 and 2, and a replay-free finish; the telemetry ring saw
    the same retries."""
    p, n = (np.arange(7) * 4 + 3) % 32, 6

    def drive(eng, clock):
        h = eng.submit(p, n)
        eng.run(max_steps=100)
        assert h.state.value == "finished"
        return eng

    tracers, engines = {}, {}
    for name, plan_cls, spec_cls, kind in (
            ("jax", JaxFaultPlan, JaxFaultSpec, JaxFaultKind),
            ("port", FaultPlan, FaultSpec, FaultKind)):
        plan = plan_cls(scheduled=[spec_cls(step=2, site="tick",
                                            kind=kind.TRANSIENT, count=2)])
        clock = FakeClock()
        tracers[name] = _tracer(name, clock=clock)
        engines[name] = drive(_engine(
            models, name, tracer=tracers[name], clock=clock, fault_plan=plan,
            max_retries=3, backoff_sleep=_no_sleep), clock)
    _assert_same_trace(tracers)
    tracer = tracers["port"]
    injected = tracer.events_named("fault_injected")
    assert [(e["step"], e["site"], e["kind"]) for e in injected] \
        == [(2, "tick", "transient")] * 2
    retries = tracer.events_named("retry")
    assert [(e["step"], e["site"], e["attempt"]) for e in retries] \
        == [(2, "tick", 1), (2, "tick", 2)]
    (span,) = list(tracer.finished)
    assert span["finish_reason"] == "length"
    assert span["attrs"]["replays"] == 0
    rec = next(r for r in engines["port"].telemetry.snapshot()
               if r["step"] == 2)
    assert rec["retries"] == 2
    # Removing the tracer unwires the injection observer.
    engines["port"].set_tracer(None)
    assert engines["port"].tracer is NULL_TRACER
    assert engines["port"]._faults.on_inject is None


def test_replay_admission_queue_wait_counts_from_requeue(models):
    """`test_serve_faults.py:232`: the replay's ``admitted`` event waits
    from the requeue (one fake second), not from the submit."""
    tracers = {}
    for name, plan_cls, spec_cls, kind in (
            ("jax", JaxFaultPlan, JaxFaultSpec, JaxFaultKind),
            ("port", FaultPlan, FaultSpec, FaultKind)):
        clock = FakeClock()
        tracers[name] = _tracer(name, clock=clock)
        eng = _engine(models, name, tracer=tracers[name], max_slots=1,
                      clock=clock, max_retries=2, backoff_sleep=_no_sleep,
                      fault_plan=plan_cls(scheduled=[spec_cls(
                          step=3, site="tick", kind=kind.TRANSIENT,
                          count=8)]))
        h = eng.submit((np.arange(8) * 3 + 1) % 32, 7)
        for _ in range(100):
            if h.done:
                break
            eng.step()
            clock.now += 1.0
        assert h.state.value == "finished" and h.replays == 1
    _assert_same_trace(tracers)
    (span,) = list(tracers["port"].finished)
    admits = [e for e in span["events"] if e["name"] == "admitted"]
    assert [a["replay"] for a in admits] == [False, True]
    assert admits[1]["queue_wait_s"] == 1.0
    assert span["duration_s"] > admits[1]["queue_wait_s"]


# --------------------------------------------------- every hook, host-only
class _HostOnlyTracer(RequestTracer):
    """A RequestTracer whose every hook first checks that no argument is
    a tensor (a hook that touched one would add a device sync)."""

    calls = {}


def _checked(name):
    real = getattr(RequestTracer, name)

    def hook(self, *args, **kwargs):
        for arg in list(args) + list(kwargs.values()):
            assert isinstance(arg, (int, float, str, bool, type(None),
                                    RequestHandle)), (name, type(arg))
            assert not isinstance(arg, (torch.Tensor, np.ndarray))
        self.calls[name] = self.calls.get(name, 0) + 1
        return real(self, *args, **kwargs)
    return hook


for _name in [n for n in vars(NullTracer) if n.startswith("on_")]:
    setattr(_HostOnlyTracer, _name, _checked(_name))


def _mixed(name, models, paged, slice_tokens, tracer):
    """Seeded faults (transient, OOM, latency), a re-arm, a best-effort
    stream preempted, a cancel, a queued deadline shed, sliced prefill,
    then a drain and a traced restore into a fresh engine."""
    from pddl_tpu.serve.request import Priority as JaxPriority

    from pddl_tpu_torch.serve import Priority

    prio = JaxPriority if name == "jax" else Priority
    kind = JaxFaultKind if name == "jax" else FaultKind
    spec = JaxFaultSpec if name == "jax" else FaultSpec
    plan = (JaxFaultPlan if name == "jax" else FaultPlan)(
        seed=1, transient_rate=0.06, oom_rate=0.03, latency_rate=0.05,
        latency_s=0.0, sleep_fn=_no_sleep, max_random_injections=12,
        scheduled=[spec(3, "tick", kind.TRANSIENT, 4)]
        + [spec(step, "tick", kind.OOM, 1) for step in (5, 6, 7)])
    clock = FakeClock()
    kw = dict(max_slots=2, prefill_len=32, prefix_chunk=8, paged=paged,
              prefill_slice_tokens=slice_tokens, fault_plan=plan,
              backoff_sleep=_no_sleep, degraded_cooldown_s=3.0, clock=clock)
    eng = _engine(models, name, tracer=tracer(clock), **kw)
    be = [eng.submit((np.arange(7) + i) % 32, 14, priority=prio.BEST_EFFORT)
          for i in range(2)]
    eng.step()
    eng.submit((np.arange(9) * 5 + 2) % 32, 5, deadline_s=0.5)
    clock.now += 1.0  # expired before it can be popped: shed
    eng.submit((np.arange(20) * 3 + 1) % 32, 6, priority=prio.INTERACTIVE)
    gone = eng.submit((np.arange(11) * 7 + 3) % 32, 5)
    for step in range(12):
        if step == 1:
            gone.cancel()
        eng.step()
        clock.now += 1.0
    snapshot = json.loads(json.dumps(eng.drain()))
    clock2 = FakeClock(50.0)
    tracer2 = tracer(clock2)
    kw.update(clock=clock2, fault_plan=None)
    eng2 = _engine(models, name, tracer=tracer2, **kw)
    restored = eng2.restore(snapshot)
    for _ in range(300):
        if not eng2.has_work:
            break
        eng2.step()
        clock2.now += 1.0
    assert all(h.done for h in restored)
    return eng.tracer, tracer2, [h.tokens for h in be] + [
        h.tokens for h in restored]


@pytest.mark.parametrize("paged,slice_tokens", [
    (False, None), (False, 8), (True, None), (True, 8)],
    ids=["row", "row-sliced", "paged", "paged-sliced"])
def test_every_hook_site_traces_as_the_jax_engine(models, paged,
                                                  slice_tokens):
    out = {}
    for name in ("jax", "port"):
        cls = jax_trace.RequestTracer if name == "jax" else _HostOnlyTracer
        out[name] = _mixed(name, models, paged, slice_tokens,
                           lambda clock, cls=cls: cls(clock=clock))
    for i in (0, 1):
        _assert_same_trace({"jax": out["jax"][i], "port": out["port"][i]})
    assert out["port"][2] == out["jax"][2]
    first = out["port"][0]
    names = {e["name"] for e in first.engine_events}
    assert {"fault_injected", "retry", "replay", "preempted",
            "degraded_entry", "degraded_exit", "drain"} <= names
    assert any(e["name"] == "deadline_shed"
               for s in first.finished for e in s["events"])
    span_events = {e["name"] for s in first.finished for e in s["events"]}
    assert {"queued", "admitted", "prefill_chunk", "first_token",
            "decode"} <= span_events
    if slice_tokens:
        assert any(e["name"] == "prefill_chunk"
                   and e["site"] == "chunk_prefill"
                   for s in first.finished for e in s["events"])
    restored = {e["name"] for s in out["port"][1].finished
                for e in s["events"]}
    assert "restored" in restored
