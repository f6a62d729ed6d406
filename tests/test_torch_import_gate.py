"""The port stands alone: `pddl_tpu_torch`, `chip_smoke.py` and
`serve_tick_ab.py` import no
`jax`, no `flax` and nothing of the JAX package, and the engine refuses
to run on a host without a card unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "pddl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pddl_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_leaves_jax_out():
    mods = list(_port_modules())
    for mod in ("serve.engine", "serve.tenant", "serve.tenant.adapters",
                "serve.tenant.grammar", "ops.lora", "ops.quant",
                "models.gpt", "models.vit", "models.layers",
                "train.optimizers", "obs.trace", "serve.drain",
                "core", "core.dist", "core.mesh", "core.collectives",
                "core.sharding", "parallel", "parallel.base",
                "parallel.single", "parallel.mirrored",
                "parallel.multiworker", "parallel.ps", "compat",
                "compat.hvd"):
        assert "pddl_tpu_torch." + mod in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_source_scan_finds_no_jax_package_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "serve_tick_ab.py"]
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_engine_raises_without_a_card(monkeypatch):
    from pddl_tpu_torch.models.llama import tiny_llama
    from pddl_tpu_torch.serve.engine import ServeEngine

    model = tiny_llama(vocab_size=32, max_len=64, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, max_slots=2, prefill_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_llama(vocab_size=32, max_len=64)
    eng = ServeEngine(model, device="cpu", max_slots=2, prefill_len=16)
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("kw", [
    {"max_replays": 4}, {"spec_k": 2, "prefill_slice_tokens": 8},
    {"preempt_cap": 1},
    {"prefill_slice_tokens": 8}, {"host_tier": 1 << 20},
    {"fault_plan": "scheduled"}, {"tenant": {"adapter_pool_slots": 2}},
    {"tracer": object()},
])
def test_unported_engine_options_raise(kw):
    """Every engine option here is ported now, each held to what it does.
    Tenancy: a ``TenantConfig`` whose adapter pool is under the floor
    (``max_slots + 1``) raises the JAX engine's ``ValueError``, in both
    packages. Fault recovery, preemption and the host tier:
    ``_check_ported_resilience``. Sliced prefill and the tracer:
    ``_check_ported_features``."""
    from pddl_tpu_torch.models.llama import tiny_llama
    from pddl_tpu_torch.serve.engine import ServeEngine
    from pddl_tpu_torch.serve.tenant import TenantConfig

    model = tiny_llama(vocab_size=32, max_len=64, device="cpu")
    if set(kw) & {"max_replays", "preempt_cap", "host_tier", "fault_plan"}:
        _check_ported_resilience(model, kw)
        return
    if set(kw) & {"prefill_slice_tokens", "tracer"}:
        _check_ported_features(model, kw)
        return
    if "tenant" in kw:
        import jax
        import jax.numpy as jnp

        from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
        from pddl_tpu.serve import ServeEngine as JaxServeEngine
        from pddl_tpu.serve.tenant import TenantConfig as JaxTenantConfig

        jm = jax_tiny_llama(vocab_size=32, max_len=64)
        params = jm.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                         train=False)["params"]
        errors = []
        for build in (
                lambda: JaxServeEngine(
                    jm, {"params": params}, max_slots=2, prefill_len=16,
                    tenant=JaxTenantConfig(**kw["tenant"])),
                lambda: ServeEngine(model, device="cpu", max_slots=2,
                                    prefill_len=16,
                                    tenant=TenantConfig(**kw["tenant"]))):
            with pytest.raises(ValueError, match="floor") as info:
                build()
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def _check_ported_features(model, kw):
    """``prefill_slice_tokens`` admits a prompt over several steps, the
    tick running between the slices (with ``spec_k`` too), and the streams
    equal whole-prompt admission's; a ``tracer`` (the case's placeholder
    becomes a ``RequestTracer``) records each request's span, and an
    object without the hooks fails at the first hook."""
    from pddl_tpu_torch.obs import RequestTracer
    from pddl_tpu_torch.serve.engine import ServeEngine

    base = dict(device="cpu", max_slots=2, prefill_len=16,
                spec_k=kw.get("spec_k", 0))
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [2, 7, 1, 8]]
    plain = ServeEngine(model, **base)
    want = [plain.submit(p, 6) for p in prompts]
    plain.run(max_steps=50)
    if "prefill_slice_tokens" in kw:
        eng = ServeEngine(model, prefix_chunk=4, **base,
                          prefill_slice_tokens=4)
        first = eng.submit(prompts[0], 6)
        steps = 0
        while not first.tokens:
            eng.step()
            steps += 1
        assert steps == 3  # 11 tokens at 4 a step
        second = eng.submit(prompts[1], 6)
        eng.run(max_steps=50)
        assert [first.tokens, second.tokens] == [h.tokens for h in want]
        return
    tracer = RequestTracer()
    eng = ServeEngine(model, tracer=tracer, **base)
    assert eng.tracer is tracer
    handles = [eng.submit(p, 6) for p in prompts]
    eng.run(max_steps=50)
    assert [h.tokens for h in handles] == [h.tokens for h in want]
    spans = {s["request_id"]: s for s in tracer.finished}
    for h in handles:
        assert spans[h.request.request_id]["attrs"]["tokens_emitted"] == 6
    bare = ServeEngine(model, tracer=kw["tracer"], **base)
    with pytest.raises(AttributeError, match="on_submit"):
        bare.submit(prompts[0], 2)


def _check_ported_resilience(model, kw):
    """``max_replays`` bounds the rebuilds before a request fails;
    ``preempt_cap`` lets an interactive arrival park a best-effort stream
    (which resumes token-exactly); ``host_tier`` arms the tier without
    changing a stream; a ``fault_plan``'s transient is retried in place."""
    from pddl_tpu_torch.serve.engine import ServeEngine
    from pddl_tpu_torch.serve.faults import FaultKind, FaultPlan, FaultSpec
    from pddl_tpu_torch.serve.request import Priority, RequestState

    base = dict(device="cpu", max_slots=2, prefill_len=16,
                backoff_sleep=lambda s: None)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    plain = ServeEngine(model, **base)
    want = plain.submit(prompt, 6)
    plain.run(max_steps=50)
    if "max_replays" in kw:
        eng = ServeEngine(model, max_retries=0, fault_plan=FaultPlan(
            sites=("tick",), transient_rate=1.0), **base, **kw)
        h = eng.submit(prompt, 6)
        eng.run(max_steps=50)
        assert h.state is RequestState.FAILED
        assert h.replays == kw["max_replays"] + 1
        return
    if "preempt_cap" in kw:
        eng = ServeEngine(model, **base, **kw)
        be = [eng.submit(prompt, 6, priority=Priority.BEST_EFFORT),
              eng.submit(prompt[::-1], 6, priority=Priority.BEST_EFFORT)]
        eng.step()
        eng.submit([7, 7, 7], 2, priority=Priority.INTERACTIVE)
        eng.step()
        assert eng.metrics.preemptions == 1
        eng.run(max_steps=50)
        assert be[0].tokens == want.tokens
        assert max(h.preemptions for h in be) == 1
        return
    if "host_tier" in kw:
        eng = ServeEngine(model, **base, **kw)
        assert eng.host_tier_enabled
        assert eng._host.byte_budget == kw["host_tier"]
    else:
        eng = ServeEngine(model, fault_plan=FaultPlan(scheduled=[
            FaultSpec(1, "tick", FaultKind.TRANSIENT)]), **base)
    h = eng.submit(prompt, 6)
    eng.run(max_steps=50)
    assert h.tokens == want.tokens
    if "fault_plan" in kw:
        assert eng.metrics.retry_sites == {"tick": 1}
        assert eng.metrics.replays == 0
