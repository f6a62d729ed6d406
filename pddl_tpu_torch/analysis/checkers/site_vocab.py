"""Rule ``site-vocab``: one site-name vocabulary per engine —
``_device_call`` literals, ``compile_counts()`` keys, and the paired
``FaultPlan.SITES`` tuple must agree.

The fault-injection machinery (utils/faults.py) validates every
scheduled fault coordinate against ``FaultPlan.SITES`` "so a typo'd
coordinate cannot silently never fire" — but nothing validated SITES
itself against the engine it describes. A site added to the engine
(a new compiled program + ``_device_call`` boundary) that never lands
in the faults vocabulary is a device-call path chaos testing can
never reach; a stale SITES entry is a vocabulary lying about the
engine. (Found on the first run of this rule in the JAX package:
``adapter_load`` was dispatchable and counted but missing from
``serve/faults.py`` SITES, so no chaos profile could target the
adapter-load path.)

Checked per engine module:

- every literal first argument of a ``_device_call(...)`` appears in
  the module's ``compile_counts()`` key set;
- every ``compile_counts()`` key appears in the paired faults module's
  ``SITES`` tuple;
- every ``SITES`` entry appears in ``compile_counts()`` keys.

The ``compile_counts()`` key set is read from its dict literals,
``counts["x"] = ...`` stores and tuple iterations, and also from the
port's form: a comprehension or loop over a method of the same class
(``{site: ... for site in self._program_sites()}``), whose keys are the
string literals that method lists (list/tuple elements and
``.append("x")`` arguments) — the port's engine builds its census by
configuration there.

Pairing: a module containing both ``_device_call`` sites and a
``SITES`` class is self-paired (test fixtures); otherwise the
``ENGINE_FAULTS_PAIRS`` path map below (engine → faults module).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    call_name,
    const_str_tuple,
    string_keys,
)

# Engine module -> its faults-vocabulary module (repo-relative path
# suffixes; resolved through the project so fixtures can shadow them).
ENGINE_FAULTS_PAIRS = (
    ("pddl_tpu_torch/serve/engine.py", "pddl_tpu_torch/serve/faults.py"),
    ("pddl_tpu_torch/train/loop.py", "pddl_tpu_torch/train/faults.py"),
)

# Storage-gate module -> its storage-faults vocabulary:
# the journal VFS's ``_storage_op`` gate literals, its STORAGE_OPS
# manifest, and ``StorageFaultPlan.SITES`` are one vocabulary — same
# invariant as the device leg, one layer down the stack.
STORAGE_FAULTS_PAIRS = (
    ("pddl_tpu_torch/serve/fleet/journal.py", "pddl_tpu_torch/utils/faults.py",
     "StorageFaultPlan"),
)


def _device_call_sites(tree: ast.AST) -> List[Tuple[str, int]]:
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_name(node) == "_device_call" \
                and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value,
                                                              str):
                sites.append((first.value, node.lineno))
    return sites


def _listed_sites(fn: ast.FunctionDef) -> Dict[str, int]:
    """The string literals a site-listing method names: elements of its
    list/tuple literals and ``.append("x")`` arguments."""
    out: Dict[str, int] = {}
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.List, ast.Tuple)):
            elts = sub.elts
        elif isinstance(sub, ast.Call) and call_name(sub) == "append":
            elts = sub.args[:1]
        else:
            continue
        for elt in elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.setdefault(elt.value, elt.lineno)
    return out


def _iterated_methods(fn: ast.FunctionDef) -> List[str]:
    """Names of the ``self.<m>()`` calls ``fn`` iterates over, in a
    comprehension or a ``for`` loop."""
    iters = [n.iter for n in ast.walk(fn)
             if isinstance(n, (ast.comprehension, ast.For))]
    return [it.func.attr for it in iters
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
            and isinstance(it.func.value, ast.Name)
            and it.func.value.id == "self"]


def _compile_counts_keys(tree: ast.AST) -> Optional[Dict[str, int]]:
    """String keys mentioned in the module's ``compile_counts``
    function(s): dict-literal keys, ``counts["x"] = ...`` stores,
    literal first elements of tuple iterations, and the sites listed by
    a same-class method it iterates over."""
    keys: Dict[str, int] = {}
    found = False
    for cls in ast.walk(tree):
        if not isinstance(cls, (ast.ClassDef, ast.Module)):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        counts_fn = methods.get("compile_counts")
        if counts_fn is None:
            continue
        for name in _iterated_methods(counts_fn):
            if name in methods:
                for key, line in _listed_sites(methods[name]).items():
                    keys.setdefault(key, line)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef)
                and node.name == "compile_counts"):
            continue
        found = True
        for sub in ast.walk(node):
            if isinstance(sub, ast.Dict):
                for key, line in string_keys(sub):
                    keys.setdefault(key, line)
            elif isinstance(sub, ast.Assign):
                for target in sub.targets:
                    if isinstance(target, ast.Subscript) \
                            and isinstance(target.slice, ast.Constant) \
                            and isinstance(target.slice.value, str):
                        keys.setdefault(target.slice.value, target.lineno)
            elif isinstance(sub, ast.Tuple) and sub.elts \
                    and isinstance(sub.elts[0], ast.Constant) \
                    and isinstance(sub.elts[0].value, str):
                keys.setdefault(sub.elts[0].value, sub.lineno)
    return keys if found else None


def _sites_tuples(tree: ast.AST) -> List[Tuple[Set[str], int, str]]:
    """Every class-level ``SITES = (...)`` assignment: (values, line,
    class name)."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            targets = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "SITES":
                    vals = const_str_tuple(value)
                    if vals is not None and vals:
                        out.append((set(vals), stmt.lineno, node.name))
    return out


def _storage_op_sites(tree: ast.AST) -> List[Tuple[str, int]]:
    """Literal first arguments of ``_storage_op(...)`` gate calls."""
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_name(node) == "_storage_op" \
                and node.args:
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value,
                                                              str):
                sites.append((first.value, node.lineno))
    return sites


def _storage_ops_tuple(tree: ast.AST) -> Optional[Tuple[Set[str], int]]:
    """The module-level ``STORAGE_OPS = (...)`` manifest, if any."""
    for node in ast.walk(tree):
        targets: List[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "STORAGE_OPS":
                vals = const_str_tuple(value)
                if vals is not None and vals:
                    return set(vals), node.lineno
    return None


class SiteVocabRule(Rule):
    name = "site-vocab"
    doc = ("_device_call sites, compile_counts() keys, and the paired "
           "FaultPlan.SITES must be one vocabulary")

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            counts = _compile_counts_keys(module.tree)
            if counts is None:
                continue
            sites = _device_call_sites(module.tree)
            if not sites and not counts:
                continue
            # Every dispatched literal site must be a counted program.
            for site, line in sites:
                if site not in counts:
                    yield self.finding(
                        module, line,
                        f"_device_call site {site!r} is not a "
                        "compile_counts() key — the dispatch is "
                        "invisible to the zero-recompile pin and "
                        "untargetable by chaos")
            vocab = self._paired_vocab(project, module)
            if vocab is None:
                continue
            sites_set, faults_mod, vocab_line, cls = vocab
            for key, line in sorted(counts.items()):
                if key not in sites_set:
                    yield self.finding(
                        module, line,
                        f"compile_counts() key {key!r} is missing from "
                        f"{cls}.SITES ({faults_mod.rel}:{vocab_line}) — "
                        "no fault profile can target this device-call "
                        "site")
            for site in sorted(sites_set - set(counts)):
                yield self.finding(
                    faults_mod, vocab_line,
                    f"{cls}.SITES entry {site!r} matches no "
                    f"compile_counts() key of {module.rel} — stale "
                    "vocabulary")
        yield from self._run_storage(project)

    def _run_storage(self, project: Project) -> Iterable:
        """The storage leg: ``_storage_op`` gate literals,
        the STORAGE_OPS manifest, and the paired
        ``StorageFaultPlan.SITES`` must be one vocabulary."""
        for module in project.modules:
            ops = _storage_ops_tuple(module.tree)
            gates = _storage_op_sites(module.tree)
            if ops is None or not gates:
                continue
            ops_set, ops_line = ops
            for op, line in gates:
                if op not in ops_set:
                    yield self.finding(
                        module, line,
                        f"_storage_op gate {op!r} is not in the "
                        "STORAGE_OPS manifest — the VFS dispatches an "
                        "op no storage-fault profile can target")
            gated = {op for op, _ in gates}
            for op in sorted(ops_set - gated):
                yield self.finding(
                    module, ops_line,
                    f"STORAGE_OPS entry {op!r} matches no _storage_op "
                    "gate — stale manifest")
            vocab = self._paired_storage_vocab(project, module)
            if vocab is None:
                continue
            sites_set, faults_mod, vocab_line, cls = vocab
            for op in sorted(ops_set - sites_set):
                yield self.finding(
                    module, ops_line,
                    f"STORAGE_OPS entry {op!r} is missing from "
                    f"{cls}.SITES ({faults_mod.rel}:{vocab_line}) — the "
                    "plan's schedule validation would reject a "
                    "coordinate the journal actually gates")
            for op in sorted(sites_set - ops_set):
                yield self.finding(
                    faults_mod, vocab_line,
                    f"{cls}.SITES entry {op!r} matches no STORAGE_OPS "
                    f"entry of {module.rel} — stale vocabulary")

    def _paired_storage_vocab(self, project: Project, module: Module):
        own = [t for t in _sites_tuples(module.tree)
               if t[2] == "StorageFaultPlan"]
        if own:
            vals, line, cls = own[0]
            return vals, module, line, cls
        for gate_suffix, faults_suffix, cls_name in STORAGE_FAULTS_PAIRS:
            if module.rel.endswith(gate_suffix):
                faults_mod = project.module_by_suffix(faults_suffix)
                if faults_mod is None:
                    return None
                tuples = [t for t in _sites_tuples(faults_mod.tree)
                          if t[2] == cls_name]
                if not tuples:
                    return None
                vals, line, cls = tuples[0]
                return vals, faults_mod, line, cls
        return None

    def _paired_vocab(self, project: Project, module: Module):
        own = _sites_tuples(module.tree)
        if own:
            vals, line, cls = own[0]
            return vals, module, line, cls
        for engine_suffix, faults_suffix in ENGINE_FAULTS_PAIRS:
            if module.rel.endswith(engine_suffix):
                faults_mod = project.module_by_suffix(faults_suffix)
                if faults_mod is None:
                    return None
                tuples = _sites_tuples(faults_mod.tree)
                if not tuples:
                    return None
                vals, line, cls = tuples[0]
                return vals, faults_mod, line, cls
        return None
