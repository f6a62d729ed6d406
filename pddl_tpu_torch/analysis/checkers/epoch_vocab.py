"""Rule ``epoch-vocab``: the fencing-epoch command manifest must agree
across the driver that stamps it and the worker that enforces it.

The router's fencing epoch is the single-writer token: a
deposed-but-alive primary is kept off the fleet because every
worker-bound fleet MUTATOR carries ``cmd["epoch"]`` and the worker's
dispatch gate refuses stale ones. That guarantee is exactly as strong
as two literal tuples staying equal — ``EPOCH_CMDS`` on the driver
side (`serve/fleet/replica.py`: the commands whose emit sites stamp
the epoch) and ``FENCED_CMDS`` on the worker side
(`serve/fleet/worker.py`: the commands the fence gate intercepts).
A command stamped but not gated is fencing theatre (the worker
ignores the field); a command gated but never stamped is a hole a
deposed primary can still drive the fleet through. Neither direction
fails a test until a split-brain actually happens — which is why the
manifest is machine-checked here instead.

Checked:

- in a module declaring ``EPOCH_CMDS``: every ``{"cmd": <literal>}``
  dict built by a function that stamps the epoch (an inline
  ``"epoch"`` key, or a ``...["epoch"] = ...`` assignment in the same
  function) names a command the manifest declares — and every
  manifest entry has at least one such stamped emit site (no stale
  manifest entries);
- in a module declaring ``FENCED_CMDS``: the tuple is SET-EQUAL to
  the paired driver module's ``EPOCH_CMDS`` (both directions:
  extra and missing reported), and every gated command actually
  appears in the worker's dispatch table (a ``== "<cmd>"``
  comparison) — gating a command no branch serves hides a typo
  forever.

Pairing: a module declaring both tuples is self-paired (test
fixtures); otherwise the path map below (worker → replica), resolved
through the project so fixtures can shadow it.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from pddl_tpu_torch.analysis.core import (
    Module,
    Project,
    Rule,
    const_str_tuple,
)

# Fence-gate mirror -> the authoritative driver-side manifest.
WORKER_DRIVER_PAIRS = (
    ("pddl_tpu_torch/serve/fleet/worker.py", "pddl_tpu_torch/serve/fleet/replica.py"),
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


def _stamped_cmd_literals(tree: ast.AST) -> List[Tuple[str, int, bool]]:
    """Every ``{"cmd": "<name>", ...}`` dict literal, function by
    function: ``(name, line, stamped)`` where ``stamped`` means the
    dict carries an inline ``"epoch"`` key OR the enclosing function
    assigns ``something["epoch"] = ...`` (the conditional-stamp
    idiom)."""
    out: List[Tuple[str, int, bool]] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fn_stamps = False
        literals: List[Tuple[str, int, bool]] = []
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign):
                for target in sub.targets:
                    if (isinstance(target, ast.Subscript)
                            and isinstance(target.slice, ast.Constant)
                            and target.slice.value == "epoch"):
                        fn_stamps = True
            if not isinstance(sub, ast.Dict):
                continue
            name: Optional[str] = None
            inline_epoch = False
            for key, value in zip(sub.keys, sub.values):
                if not isinstance(key, ast.Constant):
                    continue
                if key.value == "cmd" and isinstance(value, ast.Constant) \
                        and isinstance(value.value, str):
                    name = value.value
                elif key.value == "epoch":
                    inline_epoch = True
            if name is not None:
                literals.append((name, sub.lineno, inline_epoch))
        out.extend((name, line, inline or fn_stamps)
                   for name, line, inline in literals)
    return out


def _eq_str_literals(tree: ast.AST) -> Set[str]:
    """Every string compared with ``==``/``!=`` anywhere in the module
    — the dispatch table's branch labels."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        for op, comparator in zip(node.ops, node.comparators):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            if isinstance(comparator, ast.Constant) \
                    and isinstance(comparator.value, str):
                out.add(comparator.value)
        if isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str):
            out.add(node.left.value)
    return out


class EpochVocabRule(Rule):
    name = "epoch-vocab"
    doc = ("the fencing-epoch command manifest (driver EPOCH_CMDS / "
           "worker FENCED_CMDS) must agree both directions, every "
           "manifested command must have a stamped emit site, and "
           "every gated command a dispatch branch")

    def run(self, project: Project) -> Iterable:
        for module in project.modules:
            yield from self._check_driver(module)
            yield from self._check_worker(project, module)

    # --------------------------------------------------- driver side
    def _check_driver(self, module: Module) -> Iterable:
        declared = _module_const(module.tree, "EPOCH_CMDS")
        if declared is None:
            return
        cmds, cmds_line = declared
        stamped_names: Set[str] = set()
        for name, line, stamped in _stamped_cmd_literals(module.tree):
            if not stamped:
                continue
            stamped_names.add(name)
            if name not in cmds:
                yield self.finding(
                    module, line,
                    f"command {name!r} is emitted with an epoch stamp "
                    "but EPOCH_CMDS does not declare it — the worker "
                    "fence gate will not intercept it, so a deposed "
                    "primary can still drive the fleet through it")
        for cmd in cmds:
            if cmd not in stamped_names:
                yield self.finding(
                    module, cmds_line,
                    f"EPOCH_CMDS entry {cmd!r} has no epoch-stamped "
                    "emit site — a stale manifest entry claiming a "
                    "fence the driver never arms")

    # --------------------------------------------------- worker side
    def _driver_manifest(self, project: Project, module: Module
                         ) -> Optional[Tuple[List[str], Module, int]]:
        own = _module_const(module.tree, "EPOCH_CMDS")
        if own is not None:
            return own[0], module, own[1]
        for left, right in WORKER_DRIVER_PAIRS:
            if module.rel.endswith(left):
                driver_mod = project.module_by_suffix(right)
                if driver_mod is None:
                    return None
                paired = _module_const(driver_mod.tree, "EPOCH_CMDS")
                if paired is not None:
                    return paired[0], driver_mod, paired[1]
        return None

    def _check_worker(self, project: Project,
                      module: Module) -> Iterable:
        mirror = _module_const(module.tree, "FENCED_CMDS")
        if mirror is None:
            return
        mirror_vals, mirror_line = mirror
        manifest = self._driver_manifest(project, module)
        if manifest is not None:
            auth_vals, auth_mod, auth_line = manifest
            if set(mirror_vals) != set(auth_vals):
                extra = sorted(set(mirror_vals) - set(auth_vals))
                missing = sorted(set(auth_vals) - set(mirror_vals))
                detail = []
                if extra:
                    detail.append(f"gates unstamped commands {extra}")
                if missing:
                    detail.append(f"is missing stamped commands "
                                  f"{missing}")
                yield self.finding(
                    module, mirror_line,
                    f"FENCED_CMDS disagrees with the driver manifest "
                    f"EPOCH_CMDS ({auth_mod.rel}:{auth_line}): "
                    f"{'; '.join(detail)} — fencing is only as strong "
                    "as the stalest binary's table")
        dispatch = _eq_str_literals(module.tree)
        for cmd in mirror_vals:
            if cmd not in dispatch:
                yield self.finding(
                    module, mirror_line,
                    f"FENCED_CMDS entry {cmd!r} has no dispatch branch "
                    f"(no == {cmd!r} comparison) — the gate guards a "
                    "command no branch serves, hiding a typo forever")
