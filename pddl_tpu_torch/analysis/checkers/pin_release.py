"""Rule ``pin-release``: pin/allocate must pair with exactly one
release on every path out of the acquiring function.

The invariant (docs/ARCHITECTURE.md §7e, docs/ANALYSIS.md): a radix
chain, pool block list, or adapter row that a function pins or
allocates must, by every exit of that function, have been either

- released exactly once (``unpin``/``release``/``unassign``/``free``
  on the same receiver), or
- handed off — stored into longer-lived state (``self.*`` /
  a subscript / a container that is itself stored), passed to an
  attaching call (``extend`` et al.), or returned to the caller.

Both historical failure modes of this invariant were caught by
reading the code, not by tooling, which is why this rule exists:

- **the parked-slice drop**: a parked mid-prefill slice was dropped on
  the paged-world reset still holding allocated block ids and a pinned
  index node — a leak on an early exit path.
- **the adapter double-release**: a faulted install unwound an adapter
  pin twice — a refcount underflow on an exception path.

Analysis is intraprocedural over a structural abstract interpretation
of each function body (if/for/while/try handled; loop bodies analyzed
once). Branch merges use MAY-release semantics — an obligation
survives a merge only if it is live on *every* incoming path — so a
release on either arm of a conditional counts, and the rule errs
quiet. Exception handlers are entered with the state at ``try`` entry
(obligations acquired before the try are live there; the handler must
discharge them before re-raising). Double-release tracking is
MUST-based: a second release only fires when the first happened on
every path. Pins that legitimately outlive the function (pin at
admission, unpin at park) discharge through the hand-off rules above.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pddl_tpu_torch.analysis.core import (
    Finding,
    Module,
    Project,
    Rule,
    call_name,
    receiver_str,
    unparse,
    walk_functions,
)

# Verbs that create an obligation. "Value" acquires return the
# resource (``ids = pool.allocate(n)``); "arg" acquires take it as the
# first argument (``prefix.pin(node)``). ``pin_chain`` is the host
# tier's match-and-pin (`serve/kvcache/hosttier.py`): a
# promotion acquires the host chain through it and must ``unpin`` the
# returned tip on every exit — the demote/promote pin pair this
# vocabulary grew to cover (fixture: a promotion path that leaks the
# host pin on fault-unwind, `pin_release_bad_hosttier.py`).
ACQUIRE_VALUE = frozenset({"allocate", "assign", "acquire", "pin_chain"})
ACQUIRE_ARG = frozenset({"pin"})
RELEASE = frozenset({"release", "unpin", "unassign", "free"})
# Hand-off to longer-lived structure needs no verb list: passing a
# resource-carrying name to ANY non-release call (extend/append/
# submit/...) transfers ownership — see _handle_calls.


@dataclasses.dataclass
class _Obligation:
    key: Tuple[str, str, int]   # (receiver, resource-name, line)
    receiver: str
    resource: str
    verb: str
    line: int


class _State:
    """Abstract state along one path."""

    __slots__ = ("held", "aliases", "released", "terminated")

    def __init__(self):
        self.held: Dict[Tuple, _Obligation] = {}
        # variable name -> obligation keys it carries (aliasing via
        # plain assignment / container literals).
        self.aliases: Dict[str, Set[Tuple]] = {}
        # (receiver, path-expr, root-name) released on EVERY path so
        # far — the double-release (must) tracking set.
        self.released: Set[Tuple[str, str, str]] = set()
        self.terminated = False

    def copy(self) -> "_State":
        st = _State()
        st.held = dict(self.held)
        st.aliases = {k: set(v) for k, v in self.aliases.items()}
        st.released = set(self.released)
        st.terminated = self.terminated
        return st

    @staticmethod
    def merge(states: List["_State"]) -> "_State":
        live = [s for s in states if not s.terminated]
        if not live:
            st = _State()
            st.terminated = True
            return st
        st = _State()
        # MAY-release: an obligation survives only if live everywhere.
        keys = set(live[0].held)
        for s in live[1:]:
            keys &= set(s.held)
        st.held = {k: live[0].held[k] for k in keys}
        # MUST-release: only what every path released.
        st.released = set(live[0].released)
        for s in live[1:]:
            st.released &= s.released
        for s in live:
            for name, obls in s.aliases.items():
                st.aliases.setdefault(name, set()).update(obls)
        return st


class PinReleaseRule(Rule):
    name = "pin-release"
    doc = ("pinned/allocated resources must be released exactly once "
           "on every exit path, or handed off to longer-lived state")

    def run(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            for fn in walk_functions(module.tree):
                yield from self._check_function(module, fn)

    # ------------------------------------------------------- function
    def _check_function(self, module: Module,
                        fn: ast.FunctionDef) -> Iterable[Finding]:
        self._findings: List[Finding] = []
        self._module = module
        self._seen: Set[Tuple[int, str]] = set()
        # Enclosing ``finally`` bodies, innermost last: Python runs
        # them before a return/raise completes, so exit-time leak
        # checks must apply their releases first.
        self._finally_stack: List[List[ast.stmt]] = []
        out = self._exec_block(fn.body, _State())
        if not out.terminated:
            self._check_exit(out, fn.body[-1] if fn.body else fn,
                             "falls off the end of the function")
        return self._findings

    def _emit(self, line: int, message: str) -> None:
        if (line, message) not in self._seen:
            self._seen.add((line, message))
            self._findings.append(self.finding(self._module, line, message))

    # ------------------------------------------------------ execution
    def _exec_block(self, stmts: List[ast.stmt], st: _State) -> _State:
        for stmt in stmts:
            if st.terminated:
                break
            st = self._exec_stmt(stmt, st)
        return st

    def _exec_stmt(self, stmt: ast.stmt, st: _State) -> _State:
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._handle_assign(stmt, st)
            return st
        if isinstance(stmt, ast.Expr):
            self._handle_calls(stmt.value, st, stmt)
            return st
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._handle_calls(stmt.value, st, stmt)
                self._discharge_names(stmt.value, st)
            self._check_exit(st, stmt, "returns")
            st.terminated = True
            return st
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._handle_calls(stmt.exc, st, stmt)
            self._check_exit(st, stmt, "raises")
            st.terminated = True
            return st
        if isinstance(stmt, ast.If):
            self._handle_calls(stmt.test, st, stmt)
            s1 = self._exec_block(stmt.body, st.copy())
            s2 = self._exec_block(stmt.orelse, st.copy())
            return _State.merge([s1, s2])
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._handle_calls(stmt.iter, st, stmt)
            self._kill_target(stmt.target, st)
            body = self._exec_block(stmt.body, st.copy())
            tail = self._exec_block(stmt.orelse, st.copy()) \
                if stmt.orelse else st.copy()
            return _State.merge([body, tail, st])
        if isinstance(stmt, ast.While):
            self._handle_calls(stmt.test, st, stmt)
            body = self._exec_block(stmt.body, st.copy())
            return _State.merge([body, st])
        if isinstance(stmt, ast.Try):
            entry = st.copy()
            if stmt.finalbody:
                self._finally_stack.append(stmt.finalbody)
            try:
                after = self._exec_block(stmt.body, st)
                if stmt.orelse and not after.terminated:
                    after = self._exec_block(stmt.orelse, after)
                results = [after]
                for handler in stmt.handlers:
                    # Conservative handler entry: the state at try
                    # ENTRY — obligations acquired before the try are
                    # live and the handler owns their unwind.
                    results.append(
                        self._exec_block(handler.body, entry.copy()))
                merged = _State.merge(results)
            finally:
                if stmt.finalbody:
                    self._finally_stack.pop()
            if stmt.finalbody:
                merged = self._exec_block(stmt.finalbody, merged)
            return merged
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._handle_calls(item.context_expr, st, stmt)
            return self._exec_block(stmt.body, st)
        if isinstance(stmt, (ast.Break, ast.Continue)):
            # Loop bodies run once here; treat as end-of-path without
            # an exit check (the loop's merge keeps obligations live).
            st.terminated = True
            return st
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return st  # nested defs are analyzed as their own functions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._handle_calls(child, st, stmt)
        return st

    # ----------------------------------------------------- assignment
    def _handle_assign(self, stmt, st: _State) -> None:
        value = stmt.value
        if value is None:  # bare annotation
            return
        self._handle_calls(value, st, stmt, skip_value_acquire=True)
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]

        # A value-producing acquire assigned to a name creates the
        # obligation on that name.
        acquired = self._value_acquire(value)
        plain_names = [t.id for t in targets if isinstance(t, ast.Name)]
        if acquired is not None and plain_names:
            receiver, verb, line = acquired
            name = plain_names[0]
            self._kill_name(name, st)
            obl = _Obligation((receiver, name, line), receiver, name,
                              verb, line)
            st.held[obl.key] = obl
            st.aliases.setdefault(name, set()).add(obl.key)
            return

        carried: Set[Tuple] = set()
        for node in ast.walk(value):
            if isinstance(node, ast.Name):
                carried |= st.aliases.get(node.id, set())
        for target in targets:
            if isinstance(target, ast.Name):
                # Rebinding a name drops its old aliases, then inherits
                # whatever the RHS carries (``node = tip``).
                self._kill_name(target.id, st)
                if carried:
                    st.aliases.setdefault(target.id, set()).update(carried)
            else:
                # Store into an attribute/subscript: the carried
                # resources now live in longer-lived state — hand-off.
                for key in carried:
                    st.held.pop(key, None)
                # Mutating a path (``sl["private"] = []``) invalidates
                # its released-before record.
                path = unparse(target)
                st.released = {e for e in st.released if e[1] != path}

    def _kill_name(self, name: str, st: _State) -> None:
        st.aliases.pop(name, None)
        st.released = {e for e in st.released if e[2] != name}

    def _kill_target(self, target: ast.expr, st: _State) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                self._kill_name(node.id, st)

    def _value_acquire(self, value: ast.expr) -> Optional[Tuple[str, str,
                                                                int]]:
        if isinstance(value, ast.Call):
            verb = call_name(value)
            recv = receiver_str(value)
            if verb in ACQUIRE_VALUE and recv is not None and (
                    value.args or value.keywords):
                return recv, verb, value.lineno
        return None

    # ---------------------------------------------------------- calls
    def _handle_calls(self, expr: ast.expr, st: _State, stmt: ast.stmt,
                      skip_value_acquire: bool = False) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            verb = call_name(node)
            recv = receiver_str(node)
            if verb in ACQUIRE_ARG and recv is not None and node.args:
                res = node.args[0]
                if isinstance(res, ast.Name):
                    obl = _Obligation((recv, res.id, node.lineno), recv,
                                      res.id, verb, node.lineno)
                    st.held[obl.key] = obl
                    st.aliases.setdefault(res.id, set()).add(obl.key)
                    st.released = {e for e in st.released
                                   if e[2] != res.id}
                continue
            if verb in RELEASE and recv is not None and node.args:
                self._handle_release(node, recv, st)
                continue
            if verb in ACQUIRE_VALUE and recv is not None:
                # Handled at assignment level; a bare-expression
                # acquire (result dropped) is itself a leak.
                if not skip_value_acquire and isinstance(stmt, ast.Expr) \
                        and (node.args or node.keywords):
                    self._emit(
                        node.lineno,
                        f"result of {recv}.{verb}(...) is dropped — the "
                        "acquired resource can never be released")
                continue
            # Any other call a resource-carrying name is passed to is a
            # hand-off (extend/insert/append/submit adopt ownership).
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name):
                        for key in st.aliases.get(sub.id, set()):
                            st.held.pop(key, None)

    def _handle_release(self, node: ast.Call, recv: str,
                        st: _State) -> None:
        arg = node.args[0]
        names = [n.id for n in ast.walk(arg) if isinstance(n, ast.Name)]
        discharged = False
        for name in names:
            for key in list(st.aliases.get(name, set())):
                if key in st.held and key[0] == recv:
                    st.held.pop(key)
                    st.aliases[name].discard(key)
                    discharged = True
        # Double-release tracking is keyed by the SIMPLE path of the
        # released expression (a bare name, ``sl["row"]``, ``self.x``)
        # — walked sub-names like the ``self`` in ``self._private[i]``
        # must not collide across distinct resources.
        path = self._simple_path(arg)
        if path is None:
            return
        root = path.split(".")[0].split("[")[0]
        entry = (recv, path, root)
        if discharged:
            st.released.add(entry)
            return
        # Nothing held: either releasing state owned elsewhere (fine —
        # park/unwind paths do this constantly) or a second release of
        # a resource this function already released on every path.
        if entry in st.released:
            self._emit(
                node.lineno,
                f"{recv}.{call_name(node)}({path}) releases a resource "
                "already released on this path — refcount underflow "
                "(the adapter double-release class)")
            return
        st.released.add(entry)

    @staticmethod
    def _simple_path(arg: ast.expr) -> Optional[str]:
        """A stable identity string for name/attribute/subscript chains
        with no embedded calls; None for anything fancier."""
        for node in ast.walk(arg):
            if isinstance(node, ast.Call):
                return None
        if isinstance(arg, (ast.Name, ast.Attribute, ast.Subscript)):
            return unparse(arg)
        return None

    # ----------------------------------------------------------- exits
    def _discharge_names(self, expr: ast.expr, st: _State) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name):
                for key in st.aliases.get(node.id, set()):
                    st.held.pop(key, None)

    def _check_exit(self, st: _State, stmt: ast.stmt, how: str) -> None:
        if self._finally_stack:
            # Run enclosing finally bodies (innermost first) on a copy
            # — their releases discharge obligations before the exit
            # actually happens. The stack is cleared while doing so:
            # a return inside a finally must not re-apply it.
            st = st.copy()
            stack, self._finally_stack = self._finally_stack, []
            try:
                for fb in reversed(stack):
                    st = self._exec_block(fb, st)
            finally:
                self._finally_stack = stack
        for obl in st.held.values():
            self._emit(
                stmt.lineno,
                f"{obl.resource} ({obl.receiver}.{obl.verb} at line "
                f"{obl.line}) is still held where the function {how} — "
                "pinned resource escapes without release (the "
                "parked-slice class)")
