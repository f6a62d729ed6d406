"""Rule ``trace-vocab``: tracer event-name literals must match the
trace assembler's vocabulary.

The fleet trace stitches per-request spans from N worker processes
and the router into one trace, and the assembler's gap checker and
TTFT critical-path attribution (``obs/assemble.py``) dispatch on
EVENT NAMES: ``first_token`` anchors the attribution, ``admitted``
carries the queue wait, ``prefill_chunk`` splits by site,
``handoff``/``handoff_export``/``handoff_import`` prove the
disaggregated hand-off left no gap. An event minted under a name the
assembler does not know is silently invisible to every report — the
stream LOOKS traced, the segment table just quietly misattributes it
— and a vocabulary entry no emitter mints is the assembler promising
coverage that cannot exist. Same drift class ``site-vocab`` and
``role-vocab`` close for fault sites and replica roles.

Checked, for every module declaring a ``TRACE_EVENTS`` tuple
(authoritative: ``pddl_tpu_torch/obs/assemble.py``):

- **forward** — every event-name literal emitted by the declaring
  module or a module pairing to it (the first string-constant
  positional argument at ``event`` / ``_event`` / ``_chain_span`` /
  ``_named`` call sites) is declared in ``TRACE_EVENTS``;
- **reverse** — every ``TRACE_EVENTS`` entry is emitted at some such
  call site (no stale vocabulary).

``_engine_event`` call sites are deliberately NOT collected: the
engine-event stream (retries, fault injections, checkpoints) is a
separate vocabulary the assembler never dispatches on.

Pairing: ``TRACE_PAIRS`` maps emitter modules onto the assembler,
resolved through the project so test fixtures (which declare
``TRACE_EVENTS`` themselves and are thus self-paired) can shadow it.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    call_name,
)
from pddl_tpu_torch.analysis.checkers.role_vocab import _module_const

# Emitter module -> the module declaring the authoritative
# TRACE_EVENTS vocabulary it must match.
TRACE_PAIRS = (
    ("pddl_tpu_torch/obs/trace.py", "pddl_tpu_torch/obs/assemble.py"),
    ("pddl_tpu_torch/obs/propagate.py", "pddl_tpu_torch/obs/assemble.py"),
)

# Call names whose first string-constant positional argument is a
# trace event name (Span.event / TraceCollector._event /
# propagate._chain_span / assemble._named).
_EVENT_CALLS = ("event", "_event", "_chain_span", "_named")


def _event_literals(tree: ast.AST) -> List[Tuple[str, int]]:
    """Every event-name literal at a collected call site: the FIRST
    positional argument that is a string constant (the callees place
    the name behind a clock/rid/record argument)."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and call_name(node) in _EVENT_CALLS):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                            str):
                out.append((arg.value, node.lineno))
                break
    return out


class TraceVocabRule(Rule):
    name = "trace-vocab"
    doc = ("tracer event-name literals and the assembler's "
           "TRACE_EVENTS vocabulary must agree — an unknown event is "
           "invisible to gap checks and TTFT attribution, a stale "
           "entry promises coverage no emitter mints")

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            decl = _module_const(module.tree, "TRACE_EVENTS")
            if decl is None:
                continue
            vocab, vocab_line = decl
            emitters = [module]
            for left, right in TRACE_PAIRS:
                if not module.rel.endswith(right):
                    continue
                paired = project.module_by_suffix(left)
                if paired is not None and paired is not module:
                    emitters.append(paired)
            seen: set = set()
            for emitter in emitters:
                for name, line in _event_literals(emitter.tree):
                    seen.add(name)
                    if name not in vocab:
                        yield self.finding(
                            emitter, line,
                            f"trace event {name!r} is not in "
                            f"TRACE_EVENTS ({module.rel}:{vocab_line})"
                            " — the assembler's gap checker and "
                            "critical-path attribution cannot see it")
            for name in vocab:
                if name not in seen:
                    yield self.finding(
                        module, vocab_line,
                        f"TRACE_EVENTS entry {name!r} is emitted at no "
                        "tracer call site — stale vocabulary promising "
                        "coverage no emitter mints")
