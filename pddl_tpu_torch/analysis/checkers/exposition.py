"""Rule ``exposition-parity``: every metrics field must be reachable
from the Prometheus exposition renderers.

The runtime drift guard (tests/test_obs.py) asserts snapshot keys and
rendered series agree — but it can only see fields that made it INTO
``snapshot()``. A counter recorded on the class and never added to the
snapshot dict is invisible to both the exposition and the drift guard:
it silently never exports (found on the first run of this rule:
``ServeMetrics.retry_sites`` — per-site retry attribution recorded
from the start, never exported). This rule closes that gap statically:

- every public instance attribute a metrics class initializes in
  ``__init__`` must surface in its ``snapshot()`` dict literal — by
  exact key, or as a stem of a derived key (``ttft_s`` reservoirs
  surface as ``ttft_p50_s``/``ttft_p99_s``); attributes assigned from
  constructor parameters (configuration, not measurements) are exempt;
- every name in a ``*_COUNTER_KEYS`` frozenset (obs/export.py's
  counter-typing vocabulary) must be a key the paired snapshot
  function actually emits — a stale declaration types a ghost metric.

A class participates when it defines BOTH an ``__init__`` with
``self.*`` assignments and a ``snapshot()`` returning a dict literal
(ServeMetrics, fixture twins). Counter-key sets pair with snapshot
keys in the same module, else through ``COUNTER_KEY_BINDINGS``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    const_str_tuple,
    string_keys,
)

# obs/export.py counter vocabularies -> (module holding the snapshot
# keys, function/class scope that emits them).
COUNTER_KEY_BINDINGS = (
    ("pddl_tpu_torch/obs/export.py", "SERVE_COUNTER_KEYS",
     "pddl_tpu_torch/serve/metrics.py", "ServeMetrics"),
    ("pddl_tpu_torch/obs/export.py", "TRAIN_COUNTER_KEYS",
     "pddl_tpu_torch/train/loop.py", "Trainer"),
)


def _class_defs(tree: ast.AST) -> List[ast.ClassDef]:
    return [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _init_attrs(init: ast.FunctionDef) -> Dict[str, Tuple[int, bool]]:
    """``{attr: (line, from_param)}`` for every ``self.x = ...`` in
    __init__ (public names only)."""
    params = {a.arg for a in init.args.args} - {"self"}
    out: Dict[str, Tuple[int, bool]] = {}
    for node in ast.walk(init):
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Attribute) and isinstance(t.value,
                                                           ast.Name) \
                    and t.value.id == "self" \
                    and not t.attr.startswith("_"):
                from_param = any(
                    isinstance(n, ast.Name) and n.id in params
                    for n in ast.walk(value))
                out.setdefault(t.attr, (t.lineno, from_param))
    return out


def _snapshot_keys(fn: ast.FunctionDef,
                   cls: ast.ClassDef) -> Set[str]:
    """String keys of every dict literal in ``fn``; a ``**self.X``
    splat additionally pulls the keys of ``self.X``'s __init__ dict
    literal (the Trainer's fault_stats pattern)."""
    keys: Set[str] = set()
    splats: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k, _ in string_keys(node):
                keys.add(k)
            for k, v in zip(node.keys, node.values):
                if k is None:  # **splat
                    for sub in ast.walk(v):
                        if isinstance(sub, ast.Attribute) \
                                and isinstance(sub.value, ast.Name) \
                                and sub.value.id == "self":
                            splats.add(sub.attr)
    if splats:
        init = _method(cls, "__init__")
        if init is not None:
            for node in ast.walk(init):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and t.attr in splats \
                                and isinstance(node.value, ast.Dict):
                            for k, _ in string_keys(node.value):
                                keys.add(k)
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None \
                        and isinstance(node.target, ast.Attribute) \
                        and node.target.attr in splats \
                        and isinstance(node.value, ast.Dict):
                    for k, _ in string_keys(node.value):
                        keys.add(k)
    return keys


def _covered(attr: str, keys: Set[str]) -> bool:
    """``attr`` surfaces in some snapshot key: exact, or every ``_``
    part of the attribute appears in order inside a key (``ttft_s`` →
    ``ttft_p50_s``, ``ttft_by_priority`` → ``ttft_p99_s_by_priority``).
    """
    if attr in keys:
        return True
    parts = []
    for p in attr.split("_"):
        if not p:
            continue
        # Plural-tolerant: ``step_times`` surfaces as
        # ``step_time_p50_s``.
        stem = p[:-1] if (p.endswith("s") and len(p) > 2) else p
        parts.append(re.escape(stem) + "s?")
    pattern = re.compile(".*".join(parts))
    return any(pattern.search(key) for key in keys)


class ExpositionParityRule(Rule):
    name = "exposition-parity"
    doc = ("every metrics field must surface in snapshot()/the "
           "exposition; counter-key declarations must match emitted "
           "keys")

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            for cls in _class_defs(module.tree):
                init = _method(cls, "__init__")
                snap = _method(cls, "snapshot")
                if init is None or snap is None:
                    continue
                keys = _snapshot_keys(snap, cls)
                if not keys:
                    continue
                for attr, (line, from_param) in sorted(
                        _init_attrs(init).items()):
                    if from_param or _covered(attr, keys):
                        continue
                    yield self.finding(
                        module, line,
                        f"{cls.name}.{attr} is recorded but never "
                        "surfaces in snapshot() — invisible to the "
                        "exposition AND to the runtime drift guard")
            yield from self._check_counter_sets(project, module)

    # ------------------------------------------- counter-key parity
    def _check_counter_sets(self, project: Project,
                            module: Module) -> Iterable:
        local_snapshot_keys = self._module_snapshot_keys(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            target = node.targets[0] if node.targets else None
            if not (isinstance(target, ast.Name)
                    and target.id.endswith("_COUNTER_KEYS")):
                continue
            declared = const_str_tuple(node.value)
            if declared is None:
                continue
            emitted = self._bound_keys(project, module, target.id,
                                       local_snapshot_keys)
            if emitted is None:
                continue
            for key in sorted(set(declared) - emitted):
                yield self.finding(
                    module, node.lineno,
                    f"{target.id} declares {key!r} but no paired "
                    "snapshot emits that key — stale counter typing")

    def _module_snapshot_keys(self, module: Module) -> Set[str]:
        keys: Set[str] = set()
        for cls in _class_defs(module.tree):
            snap = _method(cls, "snapshot")
            if snap is not None:
                keys |= _snapshot_keys(snap, cls)
        return keys

    def _bound_keys(self, project: Project, module: Module,
                    set_name: str,
                    local_keys: Set[str]) -> Optional[Set[str]]:
        for export_suffix, name, metrics_suffix, cls_name in \
                COUNTER_KEY_BINDINGS:
            if module.rel.endswith(export_suffix) and set_name == name:
                target = project.module_by_suffix(metrics_suffix)
                if target is None:
                    return None
                for cls in _class_defs(target.tree):
                    if cls.name != cls_name:
                        continue
                    for fname in ("snapshot", "fault_snapshot"):
                        fn = _method(cls, fname)
                        if fn is not None:
                            return _snapshot_keys(fn, cls)
                return None
        # Same-module pairing (fixtures): counter keys next to the
        # class that emits them.
        return local_keys if local_keys else None
