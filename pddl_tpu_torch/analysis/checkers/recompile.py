"""Rule ``recompile-hazard``: per-request variation must enter traced
program bodies as runtime arrays, never as interpolated Python scalars.

The zero-recompiles-after-warmup contract (pinned by every serving
test via ``pin_zero_recompiles``) holds because the engine stamps ALL
per-request variation — sampling params, adapter ids, grammar masks,
block tables, offsets — into fixed-shape runtime arrays. A traced
body that instead closes over a request/config attribute bakes that
value into the executable: every distinct value is a silent recompile,
which on a serving tick is a multi-second stall.

Detection: functions that are jit-compiled in the module (passed to
``jax.jit`` by name — both arms of an ``a if cond else b`` selector —
or decorated with ``@jax.jit`` / ``@partial(jax.jit, ...)``) must not
read attribute chains rooted at request/config-ish names
(``request``/``req``/``handle``/``cfg``/``config``/``sampling``/
``spec``). Model topology closed over at build time (layer counts,
vocab sizes) is deliberately NOT flagged — it cannot vary per request;
the hazard is the per-request axis only.

In the port this rule is the JAX package's, unchanged: it reads jitted
bodies, and the port jits nothing, so over ``pddl_tpu_torch/`` it finds
nothing to check. It stays so that the two packages run one rule set
and agree on every fixture; no torch invariant is added in its place.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    call_name,
    walk_functions,
)

_REQUEST_ROOTS = frozenset({"request", "req", "handle", "cfg", "config",
                            "sampling", "spec"})


def _is_jit_func(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "jit":
        return True
    if isinstance(fn, ast.Name) and fn.id == "jit":
        return True
    return False


def _jitted_names(tree: ast.AST) -> Set[str]:
    """Names of functions passed (by reference) to jax.jit anywhere in
    the module, both arms of conditional selections included."""
    names: Set[str] = set()

    def collect(expr: ast.expr) -> None:
        if isinstance(expr, ast.Name):
            names.add(expr.id)
        elif isinstance(expr, ast.IfExp):
            collect(expr.body)
            collect(expr.orelse)
        elif isinstance(expr, ast.Call) and call_name(expr) == "partial" \
                and expr.args:
            # jax.jit(partial(fn, cfg)) still traces fn's body.
            collect(expr.args[0])

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_jit_func(node) and node.args:
            collect(node.args[0])
    return names


def _has_jit_decorator(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            if _is_jit_func(dec):
                return True
            if call_name(dec) == "partial" and dec.args \
                    and isinstance(dec.args[0], (ast.Attribute, ast.Name)):
                first = dec.args[0]
                attr = first.attr if isinstance(first, ast.Attribute) \
                    else first.id
                if attr == "jit":
                    return True
        elif isinstance(dec, (ast.Attribute, ast.Name)):
            attr = dec.attr if isinstance(dec, ast.Attribute) else dec.id
            if attr == "jit":
                return True
    return False


class RecompileHazardRule(Rule):
    name = "recompile-hazard"
    doc = ("traced program bodies must not interpolate request/config "
           "attributes as Python scalars — stamp runtime arrays")

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            jitted = _jitted_names(module.tree)
            for fn in walk_functions(module.tree):
                if fn.name in jitted or _has_jit_decorator(fn):
                    yield from self._check_body(module, fn)

    def _check_body(self, module: Module, fn: ast.FunctionDef) -> Iterable:
        params = {a.arg for a in (fn.args.args + fn.args.posonlyargs
                                  + fn.args.kwonlyargs)}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Attribute):
                continue
            if not isinstance(node.ctx, ast.Load):
                continue
            root = self._root_name(node)
            if root is None or root in params:
                # Arguments are traced values — attribute access on
                # them is array access, not interpolation.
                continue
            if root.lower() in _REQUEST_ROOTS:
                yield self.finding(
                    module, node.lineno,
                    f"traced body `{fn.name}` reads `{root}.{node.attr}` "
                    "from its closure — a per-request Python scalar "
                    "baked into the trace recompiles on every distinct "
                    "value; pass it as a runtime array argument instead")

    @staticmethod
    def _root_name(node: ast.Attribute) -> Optional[str]:
        base = node.value
        while isinstance(base, (ast.Attribute, ast.Subscript)):
            base = base.value
        return base.id if isinstance(base, ast.Name) else None
