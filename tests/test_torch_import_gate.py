"""The port stands alone: `pddl_tpu_torch`, `chip_smoke.py` and
`serve_tick_ab.py` import no
`jax`, no `flax`, no `optax`, `orbax` or `tensorflow` and nothing of the
JAX package, and the engine refuses to run on a host without a card
unless asked for the CPU. `examples_torch/` imports none of them and
nothing of the JAX package's `examples/`. The ImageNet input modules take
TensorFlow as a CPU input library, as the JAX package's do, but only
inside the functions that decode (`TF_INPUT_MODULES`): importing them
imports no TensorFlow."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "pddl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow",
             "pddl_tpu")


# JAX modules the port deliberately has no counterpart of, with the reason.
NOT_PORTED = {
    "utils.compile_cache": (
        "it configures XLA's persistent compile cache; the port compiles "
        "no XLA programs, and its kernels build once per source digest "
        "through ops/_kernels.py (the loader's library through "
        "data/native_loader.py)"),
}


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        if rel.name == "__main__":  # runs the CLI when imported
            continue
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
                "compat.hvd", "train.mixed_precision", "train.faults",
                "train.callbacks", "ckpt", "ckpt.checkpoint",
                "utils.preemption", "utils.summary", "ckpt.keras_import",
                "ckpt.fetch", "data.native_loader", "_lazy",
                "ckpt.hf_import", "ckpt.hf_export", "ckpt.export",
                "serve.fleet", "serve.fleet.worker", "serve.fleet.router",
                "serve.fleet.replica", "serve.fleet.journal",
                "serve.fleet.transport", "serve.fleet.standby",
                "serve.fleet.autoscaler", "obs.export", "obs.propagate",
                "obs.assemble", "obs.flightrec", "chaos",
                "chaos.conductor", "version", "config", "run",
                "models.registry", "data.text", "data.tfrecord",
                "data.imagenet", "data.pack", "utils.profiling",
                "utils.bench_artifact", "analysis", "analysis.core",
                "analysis.checkers", "analysis.checkers.pin_release",
                "analysis.checkers.site_vocab",
                "analysis.checkers.exposition",
                "analysis.checkers.snapshot_vocab",
                "analysis.checkers.role_vocab",
                "analysis.checkers.trace_vocab",
                "analysis.checkers.epoch_vocab",
                "analysis.checkers.donation",
                "analysis.checkers.recompile"):
        assert "pddl_tpu_torch." + mod in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


# Modules that import TensorFlow (and TFDS) inside a function only.
TF_INPUT_MODULES = ("pddl_tpu_torch/data/imagenet.py",
                    "pddl_tpu_torch/data/pack.py")


def _imported_roots(path, local_tf_ok=False):
    tree = ast.parse(path.read_text(), filename=str(path))
    local = set()
    if local_tf_ok:
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        if id(node) in local and isinstance(node, ast.Import) and all(
                a.name.split(".")[0] in ("tensorflow", "tensorflow_datasets")
                for a in node.names):
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_source_scan_finds_no_jax_package_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "serve_tick_ab.py"]
    for path in files:
        tf_ok = str(path.relative_to(REPO)) in TF_INPUT_MODULES
        bad = set(_imported_roots(path, tf_ok)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


# The examples' digits track encodes its PNGs with TensorFlow, inside the
# builder only, as the JAX example does.
EXAMPLES = sorted((REPO / "examples_torch").glob("*.py"))
EXAMPLES_TF_OK = ("examples_torch/real_data_convergence.py",)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_import_no_jax_and_nothing_of_the_jax_examples(path):
    """`examples_torch/` imports torch and the port: no `jax`, `flax`,
    nothing of `pddl_tpu` and nothing of the JAX package's `examples/`."""
    tf_ok = str(path.relative_to(REPO)) in EXAMPLES_TF_OK
    bad = set(_imported_roots(path, tf_ok)) & set(FORBIDDEN + ("examples",))
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
    assert "pddl_tpu_torch" in set(_imported_roots(path))


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


# JAX names whose modules wait for their ROADMAP.md queue 1 items (the
# flax TrainState has no twin: the port's trainer state is a state_dict).
WAITING = {
    "train": {"TrainState"},
    "models": set(),
    "ops": set(),
    "data": set(),
    "serve": set(),
    "ckpt": set(),
    "parallel": set(),
    "obs": set(),
    "chaos": set(),
    "serve.fleet": set(),
}
# JAX names outside the subpackages' ``__all__`` that wait (none since
# Mixtral's importer came with the routed experts).
WAITING_IN_MODULES = {"ckpt.hf_import": set()}


def _jax_all(sub):
    """The JAX subpackage's ``__all__``, read from its source (no jax)."""
    path = REPO / "pddl_tpu" / sub.replace(".", "/") / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {path}")


@pytest.mark.parametrize("sub", sorted(WAITING))
def test_subpackage_names_pinned_against_jax(sub):
    import importlib

    port = importlib.import_module(f"pddl_tpu_torch.{sub}")
    want = _jax_all(sub) - WAITING[sub]
    assert WAITING[sub] <= _jax_all(sub)
    if sub in ("serve", "ckpt"):  # these add names of their own
        assert want <= set(port.__all__)
    else:
        assert set(port.__all__) == want
    for name in want:
        assert name in dir(port)


@pytest.mark.parametrize("module", sorted(WAITING_IN_MODULES))
def test_module_names_waiting_are_the_jax_modules(module):
    import importlib

    path = REPO / "pddl_tpu" / (module.replace(".", "/") + ".py")
    defined = {node.name for node in ast.parse(path.read_text()).body
               if isinstance(node, ast.FunctionDef)}
    port = importlib.import_module(f"pddl_tpu_torch.{module}")
    for name in WAITING_IN_MODULES[module]:
        assert name in defined and not hasattr(port, name), name
    ported = {n for n in defined if not n.startswith("_")}
    assert ported - WAITING_IN_MODULES[module] <= set(dir(port))


def test_data_and_ckpt_import_no_jax_and_build_nothing():
    code = (
        "import sys\n"
        "import pddl_tpu_torch.data, pddl_tpu_torch.ckpt\n"
        "import pddl_tpu_torch.train, pddl_tpu_torch.models\n"
        "import pddl_tpu_torch.ops\n"
        "from pddl_tpu_torch.ops import _kernels\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'h5py' not in sys.modules\n"
        "assert 'transformers' not in sys.modules\n"
        "assert 'pddl_tpu_torch.data.native_loader' not in sys.modules\n"
        "assert not _kernels._libs\n"
        "from pddl_tpu_torch.data import NativeLoader\n"
        "import pddl_tpu_torch.data.native_loader as nl\n"
        "assert nl._lib is None\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_modules_not_ported_are_the_jax_modules():
    """Each JAX module listed in ``NOT_PORTED`` exists, and the port has
    no module of its name: the gap is deliberate and recorded."""
    for module, reason in NOT_PORTED.items():
        rel = module.replace(".", "/") + ".py"
        assert (REPO / "pddl_tpu" / rel).exists(), module
        assert not (PORT / rel).exists(), module
        assert reason


def test_every_jax_module_has_a_port_module_or_a_reason():
    """The census: every ``pddl_tpu/**/*.py`` has a port module at the
    same relative path, or an entry in ``NOT_PORTED``."""
    jax_pkg = REPO / "pddl_tpu"
    missing = []
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg)
        if "__pycache__" in rel.parts:
            continue
        name = ".".join(rel.with_suffix("").parts)
        if not (PORT / rel).exists() and name not in NOT_PORTED:
            missing.append(str(rel))
    assert not missing, missing
    assert len(list(jax_pkg.rglob("*.py"))) > 100


def test_top_level_names_pinned_against_jax():
    """The JAX package's top-level names are the port's too, with the
    same version and, on a host without a card, the same device counts
    (the JAX count read in a process of its own: this one runs JAX on 8
    fake CPU devices)."""
    import pddl_tpu

    import pddl_tpu_torch
    from pddl_tpu_torch.core import collectives, mesh

    assert set(pddl_tpu.__all__) <= set(pddl_tpu_torch.__all__)
    for name in pddl_tpu_torch.__all__:
        assert name in dir(pddl_tpu_torch)
    assert pddl_tpu_torch.__version__ == pddl_tpu.__version__ == "0.1.0"
    assert pddl_tpu_torch.collectives is collectives
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "from pddl_tpu.core import mesh; "
            "print(mesh.local_device_count(), mesh.global_device_count())")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         check=True, timeout=120, capture_output=True,
                         text=True).stdout.split()
    assert out == ["1", "1"]
    assert torch.cuda.device_count() == 0  # this host has no card
    assert pddl_tpu_torch.local_device_count() == 1
    assert mesh.global_device_count() == 1
