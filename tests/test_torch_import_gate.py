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
    assert "pddl_tpu_torch.serve.engine" in mods
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
    {"paged": False}, {"spec_k": 2}, {"preempt_cap": 1},
    {"prefill_slice_tokens": 8}, {"host_tier": 1 << 20},
    {"fault_plan": object()}, {"tenant": object()}, {"tracer": object()},
])
def test_unported_engine_options_raise(kw):
    from pddl_tpu_torch.models.llama import tiny_llama
    from pddl_tpu_torch.serve.engine import ServeEngine

    model = tiny_llama(vocab_size=32, max_len=64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServeEngine(model, device="cpu", max_slots=2, prefill_len=16, **kw)
