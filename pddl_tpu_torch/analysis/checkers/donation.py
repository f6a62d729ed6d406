"""Rule ``donation``: donated buffers are dead after the call, and
donated trees must never carry host-numpy leaves.

Two sub-invariants, one rule id:

**(a) read-after-donation.** Programs built with ``jax.jit(fn,
donate_argnums=...)`` consume the buffers at the donated positions —
the engine's contract is "the caller always adopts the returned tree"
(serve/engine.py's donation-discipline note). A name passed at a
donated position and then *read* later in the function, without being
reassigned from the call's result, is a use-after-free that XLA only
sometimes punishes (heap corruptions under some jaxlib builds were
exactly this class surfacing as flaky garbage reads).

**(b) host-numpy leaves riding donation.** A ``np.*`` (host) array
stored into a tree that later rides a donated site gives the runtime a
donated buffer it does not own — the documented tier-1 flake
(ROADMAP "Known flake": ``train/state.set_learning_rate`` stored a
host-numpy LR scalar into ``opt_state``, which the donated train step
then consumed; the LR would intermittently read back as
float32-bits-of-int). Detection is lexical: a ``np.``-constructed
value stored into a subscript/attribute of a donated-tree-ish name
(``*hp*``/``hyperparams``/``opt_state``/``*cache*``/``*pool*``).
Device (``jnp``) stamps are the fix and pass clean.

Scope: per-module. Donated programs are collected from ``jax.jit``
calls with a literal ``donate_argnums`` assigned to ``self._X`` /
module names; call sites both direct and through the repo's
``_device_call(site, fn, *args)`` boundary are checked. Positions
past a ``*star`` argument cannot be mapped and are skipped.

In the port this rule is the JAX package's, unchanged: it reads JAX
constructs (``jax.jit(..., donate_argnums=)``), and the port has none,
so over ``pddl_tpu_torch/`` it finds nothing to check. It stays so that
the two packages run one rule set and agree on every fixture; torch
has no donation, and no torch invariant is added in its place.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pddl_tpu_torch.analysis.core import (
    Finding,
    Module,
    Project,
    Rule,
    call_name,
    unparse,
    walk_functions,
)

_TREE_NAME_PARTS = {"hp", "hyperparams", "hyperparam", "opt_state",
                    "cache", "pool"}


def _is_jit_call(node: ast.Call) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "jit":
        return True
    if isinstance(fn, ast.Name) and fn.id == "jit":
        return True
    return False


def _donate_argnums(node: ast.Call) -> Optional[Set[int]]:
    for kw in node.keywords:
        if kw.arg != "donate_argnums":
            continue
        value = kw.value
        # ``(0,) if cond else ()`` — take the donating branch: the
        # checker guards the donating configuration.
        if isinstance(value, ast.IfExp):
            value = value.body if isinstance(value.body, ast.Tuple) \
                and value.body.elts else value.orelse
        if isinstance(value, (ast.Tuple, ast.List)):
            nums = set()
            for elt in value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value,
                                                                int):
                    nums.add(elt.value)
                else:
                    return None
            return nums
        if isinstance(value, ast.Constant) and isinstance(value.value, int):
            return {value.value}
        return None
    return None


class DonationRule(Rule):
    name = "donation"
    doc = ("names passed at donated jit positions must not be read "
           "after the call; donated trees must not carry host-numpy "
           "leaves")

    def run(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            donated = self._collect_donated(module)
            for fn in walk_functions(module.tree):
                yield from self._check_read_after(module, fn, donated)
                yield from self._check_host_leaves(module, fn)

    # ---------------------------------------------------- collection
    def _collect_donated(self, module: Module) -> Dict[str, Set[int]]:
        """``{assigned-name: donated argnums}`` for every
        ``X = jax.jit(fn, donate_argnums=...)`` in the module. Keys are
        the bare attribute/name (``_tick_p`` for ``self._tick_p``)."""
        donated: Dict[str, Set[int]] = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            if not (isinstance(value, ast.Call) and _is_jit_call(value)):
                continue
            nums = _donate_argnums(value)
            if not nums:
                continue
            for target in node.targets:
                if isinstance(target, ast.Attribute):
                    donated[target.attr] = nums
                elif isinstance(target, ast.Name):
                    donated[target.id] = nums
        return donated

    # ------------------------------------------------ read-after-free
    # Simple (non-compound) statement types: only these claim calls —
    # compound statements (if/try/while) have no assignment targets,
    # so letting them claim a child's call would make every adopted
    # donation look like a read-after-free.
    _SIMPLE = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr,
               ast.Return, ast.Raise, ast.Assert)

    def _check_read_after(self, module: Module, fn: ast.FunctionDef,
                          donated: Dict[str, Set[int]]) -> Iterable[Finding]:
        if not donated:
            return
        for stmt, continuation in self._stmts_with_continuations(fn):
            for call in [n for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)]:
                spec = self._donated_args(call, donated)
                if spec is None:
                    continue
                prog, args = spec
                targets = self._stmt_targets(stmt)
                for pos, arg in args:
                    path = self._pathable(arg)
                    if path is None:
                        continue
                    if path in targets:
                        continue  # result adopted over the donated name
                    bad = self._first_read_after(continuation, path)
                    if bad is not None:
                        yield self.finding(
                            module, bad,
                            f"`{path}` was donated to `{prog}` (argnum "
                            f"{pos}, line {call.lineno}) and is read "
                            "here without reassignment — its buffer "
                            "was consumed by the donated program")

    def _stmts_with_continuations(self, fn: ast.FunctionDef):
        """Every simple statement paired with the statements that can
        actually execute AFTER it: the rest of its own block, then the
        rest of each enclosing block, flattened — never the sibling
        arm of an `if` the statement sits in, never a different nested
        function, never an except handler the normal path skips. Loop
        back-edges are not modeled (documented limitation)."""

        def walk_block(block: List[ast.stmt], after: List[ast.stmt]):
            for i, stmt in enumerate(block):
                rest = block[i + 1:] + after
                if isinstance(stmt, self._SIMPLE):
                    yield stmt, rest
                elif isinstance(stmt, ast.If):
                    yield from walk_block(stmt.body, rest)
                    yield from walk_block(stmt.orelse, rest)
                elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    yield from walk_block(stmt.body, rest)
                    yield from walk_block(stmt.orelse, rest)
                elif isinstance(stmt, ast.Try):
                    body_after = stmt.orelse + stmt.finalbody + rest
                    yield from walk_block(stmt.body, body_after)
                    yield from walk_block(stmt.orelse,
                                          stmt.finalbody + rest)
                    for handler in stmt.handlers:
                        yield from walk_block(handler.body,
                                              stmt.finalbody + rest)
                    yield from walk_block(stmt.finalbody, rest)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    yield from walk_block(stmt.body, rest)
                # Nested defs/classes: their bodies are separate
                # control-flow universes — visited by the caller's
                # walk_functions pass, not here.

        yield from walk_block(fn.body, [])

    def _donated_args(self, call: ast.Call,
                      donated: Dict[str, Set[int]]
                      ) -> Optional[Tuple[str, List[Tuple[int, ast.expr]]]]:
        """(program-name, [(argnum, expr)]) when ``call`` dispatches a
        known donated program, directly or via ``_device_call``."""
        name = call_name(call)
        args = call.args
        prog: Optional[str] = None
        if name in donated:
            prog, offset = name, 0
        elif name == "_device_call" and len(args) >= 2:
            fn_arg = args[1]
            fn_name = (fn_arg.attr if isinstance(fn_arg, ast.Attribute)
                       else fn_arg.id if isinstance(fn_arg, ast.Name)
                       else None)
            if fn_name in donated:
                prog, offset = fn_name, 2
            else:
                return None
        else:
            return None
        out: List[Tuple[int, ast.expr]] = []
        for num in sorted(donated[prog]):
            idx = offset + num
            if idx >= len(args):
                return None
            # A *starred arg before the donated position breaks the
            # positional mapping — skip rather than guess.
            if any(isinstance(a, ast.Starred) for a in args[:idx + 1]):
                return None
            out.append((num, args[idx]))
        return prog, out

    @staticmethod
    def _pathable(arg: ast.expr) -> Optional[str]:
        if isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript)):
            for node in ast.walk(arg):
                if isinstance(node, ast.Call):
                    return None
            return unparse(arg)
        return None

    def _stmt_targets(self, stmt: ast.stmt) -> Set[str]:
        targets: Set[str] = set()
        nodes: List[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            nodes = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            nodes = [stmt.target]
        for t in nodes:
            if isinstance(t, (ast.Tuple, ast.List)):
                nodes.extend(t.elts)
            else:
                targets.add(unparse(t))
        return targets

    def _first_read_after(self, stmts: List[ast.stmt],
                          path: str) -> Optional[int]:
        """Line of the first Load of ``path`` before any Store of it
        along the continuation, else None. The scan ends at an
        unconditional block-level Return/Raise/Break/Continue — the
        enclosing-block tail behind it is unreachable from here (a
        conditional exit nested in a later compound does not stop it).
        """
        for stmt in stmts:
            stored = path in self._stmt_targets(stmt)
            loaded: Optional[int] = None
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Name, ast.Attribute,
                                     ast.Subscript)) \
                        and isinstance(getattr(node, "ctx", None),
                                       ast.Load) \
                        and unparse(node) == path:
                    loaded = node.lineno
                    break
            if loaded is not None and not stored:
                return loaded
            if stored:
                return None
            if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                                 ast.Continue)):
                return None
        return None

    # ------------------------------------------------ host-numpy leaf
    def _check_host_leaves(self, module: Module,
                           fn: ast.FunctionDef) -> Iterable[Finding]:
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.Assign):
                continue
            if not self._is_np_call(stmt.value):
                continue
            for target in stmt.targets:
                root = self._tree_store_root(target)
                if root is not None:
                    yield self.finding(
                        module, stmt.lineno,
                        f"host-numpy value stored into `{root}` — this "
                        "tree rides a donated device call, and donating "
                        "a host-owned buffer corrupts the heap (the "
                        "set_learning_rate tier-1 flake class); stamp "
                        "a device array (jnp) instead")

    @staticmethod
    def _is_np_call(value: ast.expr) -> bool:
        if not isinstance(value, ast.Call):
            return False
        fn = value.func
        root = fn
        while isinstance(root, ast.Attribute):
            root = root.value
        if not isinstance(root, ast.Name):
            return False
        return root.id in ("np", "numpy", "_np")

    @staticmethod
    def _tree_store_root(target: ast.expr) -> Optional[str]:
        """The base name of a subscript/attribute store whose
        identifier parts mark a donated tree (hp/hyperparams/
        opt_state/cache/pool)."""
        if not isinstance(target, (ast.Subscript, ast.Attribute)):
            return None
        base = target.value
        while isinstance(base, (ast.Subscript, ast.Attribute)):
            base = base.value if isinstance(base, ast.Subscript) \
                else base.value
        if not isinstance(base, ast.Name):
            return None
        parts = set(base.id.lower().strip("_").split("_"))
        if parts & _TREE_NAME_PARTS or "opt_state" in base.id:
            return base.id
        return None
