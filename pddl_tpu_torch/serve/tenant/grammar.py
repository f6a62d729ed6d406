"""Grammar-constrained decoding: regex/JSON-schema → per-step token masks
(the port's own copy of :mod:`pddl_tpu.serve.tenant.grammar`: numpy and
``json`` only, the same automata bit for bit).

The Outlines observation (Willard & Louf, 2023): constraining an LM to
a regular language reduces to a FINITE STATE MACHINE over the token
vocabulary — at every step the set of legal next tokens is a pure
function of the FSM state, so the whole constraint apparatus the engine
needs is a precomputed boolean mask table ``[n_states, V]`` and an
integer state per request. The mask is stamped into the fused tick as a
RUNTIME ``[S, V]`` array ahead of
:func:`~pddl_tpu_torch.models.gpt.sample_logits_batched` (disallowed logits →
``-inf``), which is why mixed constrained/unconstrained batches cost
zero recompiles: an unconstrained slot's row is all-True and
``where(mask, logits, -inf)`` is then bit-identical to the unmasked
logits.

Pipeline, all host-side and all at ADMISSION time (never per tick):

1. ``regex`` (a self-contained subset: literals, ``.``, escapes,
   ``[...]`` classes with ranges/negation, ``( )`` groups, ``|``,
   ``* + ?``) → character DFA via **Brzozowski derivatives** with
   ACI-normalized smart constructors (finite state set guaranteed).
2. JSON Schema (restricted subset: string/integer/number/boolean,
   ``enum``, fixed-property objects, homogeneous arrays) → a regex of
   the schema's canonical serialization → the same DFA.
3. DFA → **token FSM**: each vocabulary token's STRING is run through
   the character transitions from every live state; the result is the
   dense transition table ``[n_states, V]`` (-1 = illegal) whose
   ``>= 0`` mask is the per-state allow mask. Dead states (no path to
   acceptance) are trimmed first, so a masked greedy decode can never
   wander into a cul-de-sac it cannot finish from.

EOS handling is the ENGINE's: the mask table never mentions the eos
token — the engine ORs eos into a state's row iff the state is
accepting, and a state with NO legal tokens and no eos escape finishes
the stream with ``FinishReason.GRAMMAR`` (the output is complete by
construction — e.g. a JSON object's closing ``}`` is a no-out-edge
accepting state).

Replay/fault/migration: FSM state is NEVER snapshotted — it is a pure
function of the emitted tokens (``TokenFSM.advance_many``), re-derived
at replay admission exactly like KV is re-derived from the prompt. The
constraint SPEC (a plain JSON-able dict, see :func:`compile_constraint`)
rides the drain/fleet wire format so a migrated constrained stream
resumes under the identical automaton.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ------------------------------------------------------------ regex AST
# Hash-consed tuple ASTs with ACI-normalizing smart constructors: the
# Brzozowski derivative state space is finite only modulo associativity/
# commutativity/idempotence of alternation — frozenset alternatives and
# the absorption rules below are what bound the DFA.

EMPTY = ("empty",)  # ∅ — matches nothing
EPS = ("eps",)      # ε — matches the empty string


def _rclass(chars, negated: bool = False):
    return ("class", bool(negated), frozenset(chars))


ANY = _rclass((), negated=True)  # `.` — any character


def _cat(a, b):
    if a == EMPTY or b == EMPTY:
        return EMPTY
    if a == EPS:
        return b
    if b == EPS:
        return a
    return ("cat", a, b)


def _alt(a, b):
    if a == EMPTY:
        return b
    if b == EMPTY:
        return a
    xs = set()
    for x in (a, b):
        if x[0] == "alt":
            xs.update(x[1])
        else:
            xs.add(x)
    if len(xs) == 1:
        return next(iter(xs))
    return ("alt", frozenset(xs))


def _star(a):
    if a in (EMPTY, EPS):
        return EPS
    if a[0] == "star":
        return a
    return ("star", a)


def _nullable(r) -> bool:
    t = r[0]
    if t == "eps" or t == "star":
        return True
    if t == "empty" or t == "class":
        return False
    if t == "cat":
        return _nullable(r[1]) and _nullable(r[2])
    return any(_nullable(x) for x in r[1])  # alt


def _deriv(r, c: str):
    """Brzozowski derivative: the language of suffixes of ``r`` after
    consuming character ``c``."""
    t = r[0]
    if t == "empty" or t == "eps":
        return EMPTY
    if t == "class":
        return EPS if ((c in r[2]) != r[1]) else EMPTY
    if t == "cat":
        d = _cat(_deriv(r[1], c), r[2])
        if _nullable(r[1]):
            d = _alt(d, _deriv(r[2], c))
        return d
    if t == "alt":
        out = EMPTY
        for x in r[1]:
            out = _alt(out, _deriv(x, c))
        return out
    return _cat(_deriv(r[1], c), r)  # star


# --------------------------------------------------------- regex parser

_METACHARS = set("\\.[]()|*+?")


class RegexError(ValueError):
    """Malformed pattern (or a construct outside the supported subset —
    loud, never silently mis-parsed as literals)."""


def _regex_escape(literal: str) -> str:
    """Escape ``literal`` so the parser treats every character verbatim
    (the JSON-schema lowering escapes its serialized literals with
    this)."""
    return "".join("\\" + ch if ch in _METACHARS or ch in "^-"
                   else ch for ch in literal)


_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")


def _parse(pattern: str):
    """Recursive-descent parse of the supported subset → AST."""
    pos = [0]
    n = len(pattern)

    def peek() -> Optional[str]:
        return pattern[pos[0]] if pos[0] < n else None

    def take() -> str:
        c = pattern[pos[0]]
        pos[0] += 1
        return c

    def parse_escape():
        if pos[0] >= n:
            raise RegexError(f"dangling backslash in {pattern!r}")
        c = take()
        if c == "d":
            return _rclass(_DIGITS)
        if c == "w":
            return _rclass(_WORD)
        if c == "s":
            return _rclass(_SPACE)
        if c == "n":
            return _rclass("\n")
        if c == "t":
            return _rclass("\t")
        return _rclass(c)  # escaped literal (incl. metachars)

    def parse_class():
        negated = peek() == "^"
        if negated:
            take()
        chars = set()
        if peek() == "]":  # a leading ] is a literal (POSIX convention)
            chars.add(take())
        while True:
            c = peek()
            if c is None:
                raise RegexError(f"unterminated [ class in {pattern!r}")
            if c == "]":
                take()
                return _rclass(chars, negated)
            take()
            if c == "\\":
                if pos[0] >= n:
                    raise RegexError(f"dangling backslash in {pattern!r}")
                e = take()
                sub = {"d": _DIGITS, "w": _WORD, "s": _SPACE,
                       "n": "\n", "t": "\t"}.get(e, e)
                chars.update(sub)
                continue
            if peek() == "-" and pos[0] + 1 < n \
                    and pattern[pos[0] + 1] != "]":
                take()  # the dash
                hi = take()
                if ord(hi) < ord(c):
                    raise RegexError(
                        f"inverted range {c}-{hi} in {pattern!r}")
                chars.update(chr(o) for o in range(ord(c), ord(hi) + 1))
            else:
                chars.add(c)

    def parse_atom():
        c = peek()
        if c is None or c in "|)":
            return None
        take()
        if c == "(":
            inner = parse_alt()
            if peek() != ")":
                raise RegexError(f"unbalanced ( in {pattern!r}")
            take()
            return inner
        if c == "[":
            return parse_class()
        if c == ".":
            return ANY
        if c == "\\":
            return parse_escape()
        if c in "*+?":
            raise RegexError(
                f"quantifier {c!r} with nothing to repeat in {pattern!r}")
        return _rclass(c)  # literal (incl. { } — no brace quantifiers)

    def parse_post():
        atom = parse_atom()
        if atom is None:
            return None
        while True:
            c = peek()
            if c == "*":
                take()
                atom = _star(atom)
            elif c == "+":
                take()
                atom = _cat(atom, _star(atom))
            elif c == "?":
                take()
                atom = _alt(atom, EPS)
            else:
                return atom

    def parse_cat():
        out = EPS
        while True:
            atom = parse_post()
            if atom is None:
                return out
            out = _cat(out, atom)

    def parse_alt():
        out = parse_cat()
        while peek() == "|":
            take()
            out = _alt(out, parse_cat())
        return out

    ast = parse_alt()
    if pos[0] != n:
        raise RegexError(f"unexpected {pattern[pos[0]]!r} at "
                         f"{pos[0]} in {pattern!r}")
    return ast


# ----------------------------------------------------------- DFA (char)

# A runaway derivative expansion is a bug in the pattern or the
# normalizer, not a workload to serve — fail loudly, bounded.
MAX_DFA_STATES = 4096


class CharDFA:
    """Deterministic character automaton from derivative construction.

    ``trans[s]`` maps char → next state id; ``accepting`` is the
    nullable set; ``live`` marks states from which acceptance is
    reachable (the trim that keeps masked decoding out of dead ends).
    """

    def __init__(self, trans: List[Dict[str, int]],
                 accepting: List[bool], live: List[bool]):
        self.trans = trans
        self.accepting = accepting
        self.live = live

    def run(self, state: int, text: str) -> int:
        """Advance ``state`` through ``text``; -1 = rejected (or lands
        in a trimmed dead state)."""
        for c in text:
            state = self.trans[state].get(c, -1)
            if state < 0 or not self.live[state]:
                return -1
        return state


def _mentioned_chars(r, acc: set) -> None:
    """Characters a regex AST names explicitly (class members — negated
    classes included: their MEMBERS are the boundary). Every alphabet
    character outside this set behaves identically under derivation,
    which is the standard equivalence-class trick: derive once for one
    representative instead of once per character (a 256-char vocabulary
    with a 10-char grammar costs 11 derivative columns, not 256)."""
    t = r[0]
    if t == "class":
        acc.update(r[2])
    elif t == "cat":
        _mentioned_chars(r[1], acc)
        _mentioned_chars(r[2], acc)
    elif t == "alt":
        for x in r[1]:
            _mentioned_chars(x, acc)
    elif t == "star":
        _mentioned_chars(r[1], acc)


def build_char_dfa(pattern: str, alphabet: Sequence[str]) -> CharDFA:
    """Compile ``pattern`` over the FINITE ``alphabet`` (the set of
    characters appearing in the token vocabulary — a constraint can only
    ever emit those). Negated classes / ``.`` quantify over it."""
    root = _parse(pattern)
    alphabet = sorted(set(alphabet))
    mentioned: set = set()
    _mentioned_chars(root, mentioned)
    probe = [c for c in alphabet if c in mentioned]
    rest = [c for c in alphabet if c not in mentioned]
    if rest:
        probe.append(rest[0])  # one representative for the whole class
    ids = {root: 0}
    order = [root]
    trans: List[Dict[str, int]] = []
    i = 0
    while i < len(order):
        r = order[i]
        row: Dict[str, int] = {}
        for c in probe:
            d = _deriv(r, c)
            if d == EMPTY:
                continue
            if d not in ids:
                if len(ids) >= MAX_DFA_STATES:
                    raise RegexError(
                        f"pattern {pattern!r} exceeds {MAX_DFA_STATES} "
                        "DFA states")
                ids[d] = len(order)
                order.append(d)
            row[c] = ids[d]
        if rest and rest[0] in row:
            # The representative advanced: every unmentioned character
            # derives identically — share the target.
            tgt = row[rest[0]]
            for c in rest[1:]:
                row[c] = tgt
        trans.append(row)
        i += 1
    accepting = [_nullable(r) for r in order]
    # Trim: live = can reach an accepting state (reverse reachability).
    live = list(accepting)
    changed = True
    while changed:
        changed = False
        for s, row in enumerate(trans):
            if not live[s] and any(live[t] for t in row.values()):
                live[s] = True
                changed = True
    if not live[0]:
        raise RegexError(f"pattern {pattern!r} matches nothing over the "
                         "vocabulary's alphabet")
    return CharDFA(trans, accepting, live)


# ---------------------------------------------------------- token lift


class TokenFSM:
    """The engine-facing automaton: dense token transitions + the
    precomputed per-state allow-mask table.

    ``next_state`` is int32 ``[n_states, V]`` (-1 = illegal);
    ``mask = next_state >= 0`` is the ``[n_states, V]`` token-mask
    table the engine stamps per slot; ``accepting`` is bool
    ``[n_states]`` (the engine ORs the eos column in for these).
    State 0 is the start state. Host-side only — the device ever sees
    one ``[S, V]`` bool array per tick.
    """

    def __init__(self, next_state: np.ndarray, accepting: np.ndarray,
                 spec_key: str):
        self.next_state = next_state
        self.accepting = accepting
        self.spec_key = spec_key
        self.n_states = int(next_state.shape[0])
        self.vocab_size = int(next_state.shape[1])
        self.start = 0
        self._mask = next_state >= 0

    def allow_row(self, state: int,
                  eos_token: Optional[int] = None) -> np.ndarray:
        """The ``[V]`` bool allow mask at ``state`` (a fresh copy — the
        engine stamps it into its per-slot array), with eos allowed iff
        the state is accepting."""
        row = self._mask[state].copy()
        if eos_token is not None and self.accepting[state] \
                and 0 <= eos_token < self.vocab_size:
            row[eos_token] = True
        return row

    def advance(self, state: int, token: int) -> int:
        """Next state after emitting ``token``; -1 = not a legal
        transition (an accepting-state eos, or a corrupted stream)."""
        if not 0 <= token < self.vocab_size:
            return -1
        return int(self.next_state[state, token])

    def advance_many(self, tokens: Sequence[int],
                     eos_token: Optional[int] = None) -> int:
        """Re-derive the state for an already-emitted stream (replay /
        drain-restore / fleet migration — FSM state is never
        snapshotted, exactly like KV). A trailing eos that closed an
        accepting state is consumed without a transition; any other
        illegal token means the stream does not belong to this grammar
        and raises."""
        state = self.start
        toks = list(tokens)
        for i, t in enumerate(toks):
            nxt = self.advance(state, int(t))
            if nxt < 0:
                if (eos_token is not None and int(t) == eos_token
                        and i == len(toks) - 1
                        and self.accepting[state]):
                    return state
                raise ValueError(
                    f"token {t} at position {i} is not accepted by the "
                    "constraint (corrupted replay stream?)")
            state = nxt
        return state

    def is_dead_end(self, state: int,
                    eos_token: Optional[int] = None) -> bool:
        """No legal token and no eos escape: the stream is COMPLETE
        (trimming guarantees a dead-end state is accepting — the engine
        settles it with ``FinishReason.GRAMMAR``)."""
        if self._mask[state].any():
            return False
        return not (eos_token is not None and self.accepting[state]
                    and 0 <= eos_token < self.vocab_size)

    def accepts(self, tokens: Sequence[int],
                eos_token: Optional[int] = None) -> bool:
        """Full-sequence membership test (the tests' referee: every
        constrained stream's output must satisfy this)."""
        try:
            state = self.advance_many(tokens, eos_token=eos_token)
        except ValueError:
            return False
        return bool(self.accepting[state])


def token_fsm_from_regex(pattern: str,
                         token_strings: Sequence[str],
                         spec_key: str = "") -> TokenFSM:
    """Lift a character DFA to the token vocabulary: token ``t`` is
    legal at state ``s`` iff running its string through the DFA from
    ``s`` survives into a live state. Tokens with empty strings (pads,
    specials outside the grammar's alphabet) are never legal."""
    alphabet = set()
    for s in token_strings:
        alphabet.update(s or "")
    alphabet.update(c for c in pattern if c not in _METACHARS)
    dfa = build_char_dfa(pattern, alphabet)
    n = len(dfa.trans)
    v = len(token_strings)
    next_state = np.full((n, v), -1, np.int32)
    for s in range(n):
        if not dfa.live[s]:
            continue
        for t, text in enumerate(token_strings):
            if not text:
                continue
            tgt = dfa.run(s, text)
            if tgt >= 0:
                next_state[s, t] = tgt
    accepting = np.array(dfa.accepting, bool)
    # TOKEN-level trim on top of the character-level one: the DFA may
    # have states reachable only through character paths no token
    # tiling can complete (e.g. the grammar needs a character the
    # vocabulary lacks mid-pattern). Masks must never steer a stream
    # into such a state — a "complete" (dead-end) state must imply the
    # output is ACCEPTED. Fixpoint: a state is token-live iff accepting
    # or some token transition reaches a token-live state; transitions
    # into non-live states are erased.
    live_t = accepting.copy()
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if live_t[s]:
                continue
            tgts = next_state[s]
            if np.any((tgts >= 0) & live_t[np.clip(tgts, 0, n - 1)]):
                live_t[s] = True
                changed = True
    dead_tgt = (next_state >= 0) \
        & ~live_t[np.clip(next_state, 0, n - 1)]
    next_state[dead_tgt] = -1
    fsm = TokenFSM(next_state, accepting, spec_key)
    if not live_t[0]:
        raise RegexError(
            f"pattern {pattern!r}: no vocabulary token path can "
            "complete a match (token strings don't tile the language)")
    return fsm


# ---------------------------------------------------- JSON Schema lower

_JSON_STRING_RE = '"[^"\\\\]*"'  # no escapes inside — the v1 subset
_JSON_INT_RE = "(-?(0|[1-9][0-9]*))"
_JSON_NUM_RE = "(-?(0|[1-9][0-9]*)(\\.[0-9]+)?)"


def json_schema_to_regex(schema: Dict[str, object]) -> str:
    """A (restricted) JSON Schema → the regex of its canonical
    serialization: objects serialize their ``properties`` in DECLARED
    order with every property required and no whitespace (the canonical
    form the mask FORCES the model to emit — that determinism is the
    feature, not a bug: the closing ``}`` is a no-out-edge accepting
    state, so generation terminates exactly at a complete document).

    Supported: ``type`` string/integer/number/boolean, ``enum`` (JSON
    scalars), ``object`` with ``properties``, ``array`` with ``items``
    (optionally ``minItems`` 0/1). Anything else raises — silently
    approximating a schema would defeat the "output always validates"
    contract."""
    if "enum" in schema:
        opts = [_regex_escape(json.dumps(v, separators=(",", ":")))
                for v in schema["enum"]]  # type: ignore[index]
        if not opts:
            raise ValueError("enum must be non-empty")
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "string":
        return _JSON_STRING_RE
    if t == "integer":
        return _JSON_INT_RE
    if t == "number":
        return _JSON_NUM_RE
    if t == "boolean":
        return "(true|false)"
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict) or not props:
            raise ValueError(
                "object schemas need non-empty 'properties' (the v1 "
                "subset serializes every property, in declared order)")
        parts = []
        for key, sub in props.items():
            parts.append(_regex_escape(json.dumps(str(key))) + ":"
                         + json_schema_to_regex(sub))
        return "{" + ",".join(parts) + "}"
    if t == "array":
        if "items" not in schema:
            raise ValueError("array schemas need 'items'")
        item = json_schema_to_regex(schema["items"])  # type: ignore[arg-type]
        body = f"({item}(,{item})*)"
        if int(schema.get("minItems", 0)) < 1:  # type: ignore[arg-type]
            body += "?"
        return "\\[" + body + "\\]"
    raise ValueError(f"unsupported schema for constrained decoding: "
                     f"{schema!r}")


# ------------------------------------------------------------ spec API


def constraint_key(spec: Dict[str, object]) -> str:
    """Canonical cache/wire key of a constraint spec dict."""
    return json.dumps(spec, sort_keys=True, separators=(",", ":"))


# Module-level compile cache: TokenFSMs are immutable (per-request
# state lives in the engine as a plain int), so one compiled automaton
# can serve every engine in the process — N replicas/restarts of the
# same deployment pay one compile per (spec, vocabulary), not one per
# engine. Bounded FIFO: a runaway spec generator cannot grow it
# forever.
_FSM_CACHE: Dict[tuple, TokenFSM] = {}
_FSM_CACHE_CAP = 256


def compile_constraint(spec: Dict[str, object],
                       token_strings: Sequence[str]) -> TokenFSM:
    """The one entry point the engine uses: a JSON-able spec dict —
    ``{"kind": "regex", "pattern": ...}`` or ``{"kind": "json_schema",
    "schema": {...}}`` — plus the engine's token-id → string vocabulary,
    to a :class:`TokenFSM` (process-wide cached). Raises ``ValueError``
    on malformed specs (the engine validates at ``submit()`` so bad
    constraints reject the REQUEST, never fault a tick)."""
    cache_key = (constraint_key(spec) if isinstance(spec, dict) else None,
                 tuple(token_strings))
    cached = _FSM_CACHE.get(cache_key)
    if cached is not None:
        return cached
    fsm = _compile_constraint_uncached(spec, token_strings)
    if len(_FSM_CACHE) >= _FSM_CACHE_CAP:
        _FSM_CACHE.pop(next(iter(_FSM_CACHE)))
    _FSM_CACHE[cache_key] = fsm
    return fsm


def _compile_constraint_uncached(spec, token_strings) -> TokenFSM:
    if not isinstance(spec, dict):
        raise ValueError(f"constraint spec must be a dict, got "
                         f"{type(spec).__name__}")
    kind = spec.get("kind")
    if kind == "regex":
        pattern = spec.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise ValueError("regex constraint needs a non-empty "
                             "'pattern' string")
    elif kind == "json_schema":
        schema = spec.get("schema")
        if not isinstance(schema, dict):
            raise ValueError("json_schema constraint needs a 'schema' "
                             "dict")
        pattern = json_schema_to_regex(schema)
    else:
        raise ValueError(
            f"unknown constraint kind {kind!r} (expected 'regex' or "
            "'json_schema')")
    return token_fsm_from_regex(pattern, token_strings,
                                spec_key=constraint_key(spec))


def encode_text(text: str, token_strings: Sequence[str]) -> List[int]:
    """Greedy longest-match tokenizer over ``token_strings`` (test/
    bench convenience for building prompts in grammar vocabularies;
    raises when ``text`` cannot be tiled)."""
    by_len = sorted(((s, i) for i, s in enumerate(token_strings) if s),
                    key=lambda p: -len(p[0]))
    out: List[int] = []
    pos = 0
    while pos < len(text):
        for s, i in by_len:
            if text.startswith(s, pos):
                out.append(i)
                pos += len(s)
                break
        else:
            raise ValueError(f"cannot tokenize {text[pos:pos+8]!r} with "
                             "the given token strings")
    return out


def decode_tokens(tokens: Sequence[int],
                  token_strings: Sequence[str],
                  eos_token: Optional[int] = None) -> str:
    """Token ids → text (dropping a trailing eos) — the referee-side
    inverse of :func:`encode_text`."""
    toks = list(tokens)
    if eos_token is not None and toks and toks[-1] == eos_token:
        toks = toks[:-1]
    return "".join(token_strings[t] for t in toks)
