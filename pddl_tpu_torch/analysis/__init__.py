"""graftlint — static invariant analysis for the pddl_tpu_torch engine
(the port of :mod:`pddl_tpu.analysis`).

``python -m pddl_tpu_torch.analysis --check pddl_tpu_torch/``
machine-checks the stack's load-bearing conventions (pin/release
pairing, donation discipline, recompile hazards, site vocabularies,
exposition parity, snapshot hygiene) at pure-AST level: no torch, jax
or ``pddl_tpu`` import, no module execution, sub-second over the whole
tree — cheap enough for every test run
(``tests/test_torch_analysis.py``, marker ``analysis``).

The rules are the JAX package's, with their module pairs naming the
port's files. ``docs/ANALYSIS.md`` is the invariant catalogue,
suppression and baseline syntax, and how to add a checker.
"""

from __future__ import annotations

from pddl_tpu_torch.analysis.core import (  # noqa: F401 - the public surface
    DEFAULT_BASELINE,
    Finding,
    Project,
    Rule,
    all_rules,
    apply_baseline,
    load_baseline,
    run_analysis,
)

__all__ = [
    "DEFAULT_BASELINE",
    "Finding",
    "Project",
    "Rule",
    "all_rules",
    "apply_baseline",
    "load_baseline",
    "run_analysis",
]
