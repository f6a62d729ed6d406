"""Rule ``role-vocab``: the disaggregation-era control-plane
vocabularies — journal record kinds, route/via labels, and replica
roles — must agree across the modules that mint and consume them.

Disaggregated serving splits the fleet into roles (``prefill``/
``decode``/``unified``) with a WAL record kind of its own
(``handoff``). Each of
those vocabularies now lives in two places by construction: the
router mints route labels the journal's forensic reader must
classify (``VIA_LABELS``), the journal's recovery fold dispatches on
the ``"rec"`` kinds its encoders emit (``RECORD_KINDS``), and the
worker entrypoint validates the role string the replica driver
declares (``ROLES``, authoritative in ``serve/fleet/disagg.py``).
A label or kind minted on one side and missing on the other is a
binding the reader silently cannot classify — the same
vocabulary-drift class ``site-vocab`` closes for fault sites.

Checked:

- in a module declaring ``RECORD_KINDS``: every ``"rec"`` literal an
  ``encode*`` function emits is listed, and every listed kind is
  emitted by some encoder (no stale kinds);
- in a module declaring ``ROUTE_LABELS``: every label appears in the
  paired journal module's ``VIA_LABELS``;
- literal ``via`` arguments at ``encode_route(...)`` call sites
  appear in ``VIA_LABELS``;
- a module declaring a ``ROLES`` mirror (``worker.py``) matches the
  authoritative ``ROLES`` in ``disagg.py`` exactly.

Pairing: a module declaring ``VIA_LABELS`` itself is self-paired
(test fixtures); otherwise the path maps below (router → journal,
worker → disagg), resolved through the project so fixtures can
shadow them.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    call_name,
    const_str_tuple,
)

# Label-minting module -> the journal module declaring VIA_LABELS.
ROUTER_JOURNAL_PAIRS = (
    ("pddl_tpu_torch/serve/fleet/router.py", "pddl_tpu_torch/serve/fleet/journal.py"),
)

# ROLES mirror -> the authoritative ROLES declaration.
ROLES_PAIRS = (
    ("pddl_tpu_torch/serve/fleet/worker.py", "pddl_tpu_torch/serve/fleet/disagg.py"),
)


def _module_const(tree: ast.AST,
                  name: str) -> Optional[Tuple[List[str], int]]:
    """A module-level ``NAME = ("a", "b", ...)`` string tuple:
    ``(values, line)``, or None."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == name:
                vals = const_str_tuple(node.value)
                if vals is not None:
                    return vals, node.lineno
    return None


def _emitted_rec_kinds(tree: ast.AST) -> List[Tuple[str, int]]:
    """Every literal ``"rec": "<kind>"`` a ``*encode*`` function
    emits: ``(kind, line)``."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef)
                and "encode" in node.name):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Dict):
                continue
            for key, value in zip(sub.keys, sub.values):
                if isinstance(key, ast.Constant) and key.value == "rec" \
                        and isinstance(value, ast.Constant) \
                        and isinstance(value.value, str):
                    out.append((value.value, value.lineno))
    return out


def _route_call_vias(tree: ast.AST) -> List[Tuple[str, int]]:
    """Literal ``via`` arguments at ``encode_route(...)`` call sites
    (third positional or ``via=`` keyword)."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and call_name(node) == "encode_route"):
            continue
        arg: Optional[ast.expr] = None
        if len(node.args) >= 3:
            arg = node.args[2]
        else:
            for kw in node.keywords:
                if kw.arg == "via":
                    arg = kw.value
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((arg.value, node.lineno))
    return out


class RoleVocabRule(Rule):
    name = "role-vocab"
    doc = ("journal RECORD_KINDS, router ROUTE_LABELS/via literals, "
           "and replica ROLES must agree across their declaring "
           "modules")

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            yield from self._check_record_kinds(module)
            yield from self._check_route_labels(project, module)
            yield from self._check_roles(project, module)

    # --------------------------------------------------- record kinds
    def _check_record_kinds(self, module: Module) -> Iterable:
        declared = _module_const(module.tree, "RECORD_KINDS")
        if declared is None:
            return
        kinds, kinds_line = declared
        emitted = _emitted_rec_kinds(module.tree)
        for kind, line in emitted:
            if kind not in kinds:
                yield self.finding(
                    module, line,
                    f"encoder emits record kind {kind!r} that "
                    "RECORD_KINDS does not declare — recovery's fold "
                    "has no reader-side decision for it (rebuild vs "
                    "audit-only)")
        emitted_set = {k for k, _ in emitted}
        for kind in kinds:
            if kind not in emitted_set:
                yield self.finding(
                    module, kinds_line,
                    f"RECORD_KINDS entry {kind!r} is emitted by no "
                    "encoder — stale vocabulary lying about the wire")

    # --------------------------------------------------- route labels
    def _via_labels(self, project: Project,
                    module: Module) -> Optional[Tuple[List[str],
                                                      Module, int]]:
        own = _module_const(module.tree, "VIA_LABELS")
        if own is not None:
            return own[0], module, own[1]
        for left, right in ROUTER_JOURNAL_PAIRS:
            if module.rel.endswith(left):
                journal_mod = project.module_by_suffix(right)
                if journal_mod is None:
                    return None
                paired = _module_const(journal_mod.tree, "VIA_LABELS")
                if paired is not None:
                    return paired[0], journal_mod, paired[1]
        return None

    def _check_route_labels(self, project: Project,
                            module: Module) -> Iterable:
        labels = _module_const(module.tree, "ROUTE_LABELS")
        vias = self._via_labels(project, module)
        if labels is not None and vias is not None:
            label_vals, labels_line = labels
            via_vals, via_mod, via_line = vias
            for label in label_vals:
                if label not in via_vals:
                    yield self.finding(
                        module, labels_line,
                        f"ROUTE_LABELS entry {label!r} is missing "
                        f"from VIA_LABELS ({via_mod.rel}:{via_line}) "
                        "— a route record the forensic reader cannot "
                        "classify")
        if vias is not None:
            via_vals = vias[0]
            for via, line in _route_call_vias(module.tree):
                if via not in via_vals:
                    yield self.finding(
                        module, line,
                        f"encode_route called with via={via!r}, which "
                        "VIA_LABELS does not declare — an "
                        "unclassifiable binding provenance")

    # ---------------------------------------------------------- roles
    def _check_roles(self, project: Project, module: Module) -> Iterable:
        mirror = _module_const(module.tree, "ROLES")
        if mirror is None:
            return
        for left, right in ROLES_PAIRS:
            if not module.rel.endswith(left):
                continue
            auth_mod = project.module_by_suffix(right)
            if auth_mod is None:
                continue
            auth = _module_const(auth_mod.tree, "ROLES")
            if auth is None:
                continue
            mirror_vals, mirror_line = mirror
            auth_vals, auth_line = auth
            if set(mirror_vals) != set(auth_vals):
                extra = sorted(set(mirror_vals) - set(auth_vals))
                missing = sorted(set(auth_vals) - set(mirror_vals))
                detail = []
                if extra:
                    detail.append(f"declares unknown roles {extra}")
                if missing:
                    detail.append(f"is missing roles {missing}")
                yield self.finding(
                    module, mirror_line,
                    f"ROLES mirror disagrees with the authoritative "
                    f"vocabulary ({auth_mod.rel}:{auth_line}): "
                    f"{'; '.join(detail)} — the worker would "
                    "accept/reject roles the fleet does not")
