"""graftlint core: the import-free AST checker framework.

The serving/training stack runs on a handful of load-bearing
conventions — pin-before-allocate with a release on every unwind path,
all per-request variation as runtime arrays, one donated tree per
site, shared site-name vocabularies, strict metrics-exposition parity,
snapshot-version bumps — and each has been broken before in ways no
test caught. This package machine-checks them at the AST level,
RacerD/error-prone-style:

- **no runtime import** of torch or jax (or of any checked module) —
  rules see syntax trees only, so the whole suite runs in well under a second
  and is safe inside every tier-1 test run;
- **per-rule visitor registry** (`pddl_tpu_torch/analysis/checkers/`), each
  rule encoding one repo invariant and documented in
  ``docs/ANALYSIS.md`` next to the incident that motivated it;
- **suppressions**: ``# graftlint: disable=<rule>[,<rule>]`` on the
  flagged line (or the line above), ``# graftlint: disable-file=<rule>``
  anywhere at a line's start for a whole file;
- **baseline** (:func:`load_baseline`): a JSON list of justified
  exceptions keyed by ``(rule, path, symbol)`` with a mandatory
  ``reason`` — the escape hatch for true-but-accepted findings; stale
  entries FAIL the run so the baseline can only shrink honestly.

The CLI lives in ``pddl_tpu_torch/analysis/__main__.py``:
``python -m pddl_tpu_torch.analysis --check pddl_tpu_torch/``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Repo root: the directory that contains the `pddl_tpu_torch` package this
# module is part of.  Cross-file rules (site vocabularies, exposition
# parity, artifact vocab) resolve their companion files against it.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_DISABLE_RE = re.compile(r"#\s*graftlint:\s*disable=([\w,\- ]+)")
_DISABLE_FILE_RE = re.compile(r"^\s*#\s*graftlint:\s*disable-file=([\w,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, addressable three ways: by ``path:line``
    (the human jump-to), by ``(rule, path, symbol)`` (the baseline
    key — line numbers drift, enclosing-function names rarely do), and
    by the suppression comment on the flagged line."""

    rule: str
    path: str        # repo-root-relative, forward slashes
    line: int        # 1-indexed
    symbol: str      # enclosing def/class qualname, or "<module>"
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}" \
               f" (in {self.symbol})"


class Module:
    """One parsed source file plus the lint-directive index."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set(rule) suppressions; "*" suppresses every rule.
        self.line_disables: Dict[int, set] = {}
        self.file_disables: set = set()
        for i, text in enumerate(self.lines, 1):
            m = _DISABLE_FILE_RE.match(text)
            if m:
                self.file_disables.update(
                    r.strip() for r in m.group(1).split(",") if r.strip())
                continue
            m = _DISABLE_RE.search(text)
            if m:
                self.line_disables[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()}
        # Qualname index: line -> enclosing def/class chain.
        self._symbols: List[Tuple[int, int, str]] = []
        self._index_symbols(self.tree, [])

    def _index_symbols(self, node, stack: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = ".".join(stack + [child.name])
                end = getattr(child, "end_lineno", child.lineno)
                self._symbols.append((child.lineno, end, qual))
                self._index_symbols(child, stack + [child.name])
            else:
                self._index_symbols(child, stack)

    def symbol_at(self, line: int) -> str:
        best = "<module>"
        best_span = None
        for lo, hi, qual in self._symbols:
            if lo <= line <= hi:
                span = hi - lo
                if best_span is None or span <= best_span:
                    best, best_span = qual, span
        return best

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disables or "*" in self.file_disables:
            return True
        for ln in (line, line - 1):
            rules = self.line_disables.get(ln)
            if rules and (rule in rules or "*" in rules):
                return True
        return False


class Project:
    """The file set one analysis run sees, with lazy cross-file loads.

    ``paths`` (files or directories) define the modules rules iterate;
    :meth:`module_by_suffix` additionally resolves companion files
    (e.g. the faults module paired with an engine) from the scanned set
    first and the repo root second, so the vocabulary rules work both
    on the real tree and on self-contained test fixtures.
    """

    def __init__(self, paths: Sequence[str], root: Optional[str] = None):
        self.root = os.path.abspath(root or REPO_ROOT)
        self.errors: List[str] = []
        self._by_rel: Dict[str, Module] = {}
        self._extra: Dict[str, Optional[Module]] = {}
        for p in paths:
            # A path that does not exist must be an ERROR, never a
            # silent zero-file "clean" — the gate's green must mean
            # "analyzed and found nothing", not "found nothing to
            # analyze" (typo'd path, wrong cwd).
            if not os.path.exists(p):
                self.errors.append(f"{p}: no such file or directory")
            elif os.path.isfile(p) and not p.endswith(".py"):
                self.errors.append(
                    f"{p}: not a Python source file (.py)")
        for path in self._expand(paths):
            rel = self._relpath(path)
            try:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                self._by_rel[rel] = Module(path, rel, source)
            except (OSError, SyntaxError) as e:
                self.errors.append(f"{rel}: cannot parse: {e}")
        if not self._by_rel and not self.errors:
            self.errors.append(
                f"no Python files found under {list(paths)!r}")

    def _relpath(self, path: str) -> str:
        path = os.path.abspath(path)
        if path.startswith(self.root + os.sep):
            path = os.path.relpath(path, self.root)
        return path.replace(os.sep, "/")

    @staticmethod
    def _expand(paths: Sequence[str]) -> Iterable[str]:
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if d != "__pycache__" and not d.startswith("."))
                    for name in sorted(filenames):
                        if name.endswith(".py"):
                            yield os.path.join(dirpath, name)
            elif p.endswith(".py"):
                yield p

    @property
    def modules(self) -> List[Module]:
        return [self._by_rel[k] for k in sorted(self._by_rel)]

    def module_by_suffix(self, suffix: str) -> Optional[Module]:
        """The scanned module whose relative path ends with ``suffix``,
        else a lazily-parsed load from the repo root, else None."""
        for rel in sorted(self._by_rel):
            if rel.endswith(suffix):
                return self._by_rel[rel]
        if suffix not in self._extra:
            path = os.path.join(self.root, suffix)
            mod = None
            if os.path.isfile(path):
                try:
                    with open(path, encoding="utf-8") as f:
                        mod = Module(path, suffix, f.read())
                except (OSError, SyntaxError) as e:
                    self.errors.append(f"{suffix}: cannot parse: {e}")
            self._extra[suffix] = mod
        return self._extra[suffix]

    def module_for_path(self, rel: str) -> Optional[Module]:
        """The module a finding's path refers to — scanned set first,
        then lazily-loaded companions, so suppression comments work
        identically whether the file was a CLI argument or a
        cross-file resolve."""
        mod = self._by_rel.get(rel)
        if mod is not None:
            return mod
        for extra in self._extra.values():
            if extra is not None and extra.rel == rel:
                return extra
        return None


class Rule:
    """Base class: subclasses set ``name``/``doc`` and implement
    :meth:`run` yielding raw findings; the framework applies
    suppressions and the baseline afterwards."""

    name: str = ""
    doc: str = ""

    def run(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError

    # Convenience for rules that visit one module at a time.
    def finding(self, module: Module, line: int, message: str) -> Finding:
        return Finding(self.name, module.rel, line,
                       module.symbol_at(line), message)


# --------------------------------------------------------------- baseline

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "graftlint_baseline.json")


def load_baseline(path: Optional[str]) -> List[dict]:
    """The justified-exception list: ``[{rule, path, symbol, reason},
    ...]``. Every entry must carry a non-empty ``reason`` — an
    unexplained baseline is just a disabled checker."""
    if path is None or not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path!r} must be a JSON list")
    seen = set()
    for e in entries:
        for key in ("rule", "path", "symbol", "reason"):
            if not isinstance(e.get(key), str) or not e[key].strip():
                raise ValueError(
                    f"baseline entry {e!r} needs a non-empty {key!r}")
        k = (e["rule"], e["path"], e["symbol"])
        if k in seen:
            # One justification per location; a duplicate would match
            # nothing and masquerade as a stale entry.
            raise ValueError(f"duplicate baseline entry for {k}")
        seen.add(k)
    return entries


def apply_baseline(findings: List[Finding],
                   entries: List[dict],
                   *,
                   analyzed_paths: Optional[set] = None,
                   active_rules: Optional[set] = None
                   ) -> Tuple[List[Finding], List[dict], List[dict]]:
    """Split findings into (kept, used_entries, stale_entries). An
    entry absorbs EVERY finding with its (rule, path, symbol) — one
    justification per code location, not per occurrence.

    Staleness is judged only INSIDE the run's scope: an entry whose
    path was not analyzed this run (``analyzed_paths``) or whose rule
    did not run (``active_rules``) is out of scope — neither used nor
    stale — so a targeted ``--rules``/single-file invocation never
    demands removal of a justified exception it could not re-observe.
    """
    kept: List[Finding] = []
    used = {i: False for i in range(len(entries))}
    index = {}
    for i, e in enumerate(entries):
        index.setdefault((e["rule"], e["path"], e["symbol"]), i)
    for f in findings:
        i = index.get((f.rule, f.path, f.symbol))
        if i is None:
            kept.append(f)
        else:
            used[i] = True
    stale = []
    for i, u in used.items():
        if u:
            continue
        e = entries[i]
        if analyzed_paths is not None and e["path"] not in analyzed_paths:
            continue
        if active_rules is not None and e["rule"] not in active_rules:
            continue
        stale.append(e)
    return kept, [entries[i] for i, u in used.items() if u], stale


# -------------------------------------------------------------------- run


def all_rules() -> List[Rule]:
    from pddl_tpu_torch.analysis.checkers import RULES

    return [cls() for cls in RULES]


def run_analysis(paths: Sequence[str], *,
                 rules: Optional[Sequence[Rule]] = None,
                 root: Optional[str] = None
                 ) -> Tuple[List[Finding], List[str], set]:
    """Run ``rules`` (default: every registered checker) over ``paths``.
    Returns ``(findings, errors, analyzed_paths)`` with suppressions
    already applied — baseline filtering is the caller's second step
    (the CLI's, usually); ``analyzed_paths`` (scanned modules plus
    lazily-resolved companions) scopes the staleness judgment in
    :func:`apply_baseline`."""
    project = Project(paths, root=root)
    findings: List[Finding] = []
    seen = set()
    for rule in (rules if rules is not None else all_rules()):
        for f in rule.run(project):
            if f in seen:  # nested defs can be visited twice
                continue
            seen.add(f)
            mod = project.module_for_path(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    analyzed = set(project._by_rel) | {
        m.rel for m in project._extra.values() if m is not None}
    return findings, project.errors, analyzed


# ------------------------------------------------------------ AST helpers
# Shared by the checkers; kept here so each rule file stays about its
# invariant, not about AST plumbing.


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - very old py
        return "<expr>"


def call_name(node: ast.Call) -> Optional[str]:
    """The called attribute/function name: ``x.y.pin(...)`` -> "pin",
    ``jit(...)`` -> "jit"."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def receiver_str(node: ast.Call) -> Optional[str]:
    """The dotted receiver of a method call: ``self._prefix.pin(n)`` ->
    "self._prefix"; None for bare-name calls."""
    if isinstance(node.func, ast.Attribute):
        return unparse(node.func.value)
    return None


def string_keys(d: ast.Dict) -> List[Tuple[str, int]]:
    out = []
    for k in d.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out.append((k.value, k.lineno))
    return out


def const_str_tuple(node: ast.AST) -> Optional[List[str]]:
    """A tuple/list/set literal of string constants, or None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            vals.append(elt.value)
        return vals
    if isinstance(node, ast.Call) and call_name(node) == "frozenset" \
            and node.args:
        return const_str_tuple(node.args[0])
    return None


def walk_functions(tree: ast.AST):
    """Every FunctionDef in the module, nested ones included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            yield node
