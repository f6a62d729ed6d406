"""The port's grammar machinery (`pddl_tpu_torch/serve/tenant/grammar.py`)
against the JAX package's on the same patterns, schemas and vocabularies.

Every regex and JSON schema of `tests/test_serve_tenant.py`'s grammar
tests, over its own vocabulary (the 32-token `VOCAB32`, `abc`, the number
vocabulary, multi-character tokens) and over a seeded 2,000-token
vocabulary (`VOCAB32` then strings of 1-4 printable ASCII characters):
the token FSM's `next_state` table and `accepting` vector are equal
(exactly), or both packages raise the same error type with the same
message. Then `json_schema_to_regex`, `constraint_key`, `encode_text` /
`decode_tokens`, `accepts`, and a seeded walk of `allow_row` / `advance`
/ `advance_many` / `is_dead_end` (with and without an eos token) give
the same answers. Exact equality throughout: the automata are integer
tables.
"""

import numpy as np
import pytest

import pddl_tpu.serve.tenant.grammar as jg
import pddl_tpu_torch.serve.tenant.grammar as tg

VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))


def _vocab2000():
    rng = np.random.RandomState(0)
    chars = [chr(c) for c in range(32, 127)]
    extra = ["".join(rng.choice(chars, rng.randint(1, 5)))
             for _ in range(2000 - len(VOCAB32))]
    return VOCAB32 + extra


VOCABS = {"v32": VOCAB32, "abc": list("abc"),
          "num": list("0123456789ab\"\\-x."), "multi": ["ab", "c", "abc"],
          "v2000": _vocab2000()}

OBJ = {"type": "object", "properties": {
    "id": {"type": "integer"}, "ab": {"type": "string"},
    "ed": {"type": "boolean"}}}
SCHEMAS = {
    "object": OBJ,
    "array": {"type": "array", "items": {"type": "integer"}},
    "enum": {"enum": ["ab", 7]},
    "untileable": {"type": "object",
                   "properties": {"zz": {"type": "integer"}}},
    "id_ok": {"type": "object", "properties": {
        "id": {"type": "integer"}, "ok": {"type": "boolean"}}},
    "number": {"type": "number"},
    "min_items": {"type": "array", "items": {"type": "boolean"},
                  "minItems": 1},
}
# (pattern, its own vocabulary, texts to encode and test for acceptance)
REGEXES = [
    ("(ab|a)c*", "abc", ["a", "ab", "abcc", "ac", "b", "aba"]),
    (r"-?\d+(\.\d+)?", "num", ["42", "-7.25", "4.", "x"]),
    (r'"[^"\\]*"', "num", ['"ab0"', '"a"b"']),
    ("[a-b]+", "num", ["abba", "0"]),
    ("abc+", "multi", ["ab", "abc", "abcc", "c"]),
    ("(abx|ac)", "abc", ["ac", "ab"]),
    ("[ab]x[ab]", "abc", ["a"]),
    ("[0-9][0-9][0-9]", "v32", ["123", "12", "1234"]),
    ("x*", "v32", ["", "a"]),
    ("*a", "abc", ["a"]),
    ("(a", "abc", ["a"]),
]
SCHEMA_TEXTS = ['{"id":42,"ab":"cig","ed":true}',
                '{"id":-7,"ab":"","ed":false}',
                '{"ab":"cig","id":42,"ed":true}', "[1,2,30]", "[]", "[1,]",
                '"ab"', "7", '{"id":3,"ok":true}', "-0.5", "[true]"]


def _outcome(fn, *args):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args))
    except (ValueError, KeyError) as e:
        return ("raise", type(e).__name__, str(e))


def _assert_same_fsm(j, t):
    assert type(t).__name__ == "TokenFSM"
    assert t.n_states == j.n_states and t.vocab_size == j.vocab_size
    np.testing.assert_array_equal(t.next_state, j.next_state)
    np.testing.assert_array_equal(t.accepting, j.accepting)
    assert t.next_state.dtype == j.next_state.dtype
    assert t.spec_key == j.spec_key and t.start == j.start


def _walk(j, t, seed, eos):
    """A seeded walk through legal tokens: the same allow rows, steps,
    dead ends and acceptance, the stream re-derived by advance_many."""
    rng = np.random.RandomState(seed)
    state, stream = j.start, []
    for _ in range(24):
        row = j.allow_row(state, eos)
        np.testing.assert_array_equal(t.allow_row(state, eos), row)
        assert t.is_dead_end(state, eos) == j.is_dead_end(state, eos)
        if not row.any():
            break
        tok = int(rng.choice(np.flatnonzero(row)))
        stream.append(tok)
        if tok == eos:
            break
        nxt = j.advance(state, tok)
        assert t.advance(state, tok) == nxt >= 0
        state = nxt
        assert t.advance_many(stream, eos_token=eos) == state
    assert t.accepts(stream, eos_token=eos) == j.accepts(stream,
                                                         eos_token=eos)
    assert t.advance(0, -1) == j.advance(0, -1) == -1


def _check(j_fsm, t_fsm, vocab, texts, seed):
    if j_fsm[0] == "raise":
        assert t_fsm == j_fsm
        return
    assert t_fsm[0] == "ok", t_fsm
    j, t = j_fsm[1], t_fsm[1]
    _assert_same_fsm(j, t)
    for text in texts:
        enc = _outcome(tg.encode_text, text, vocab)
        assert enc == _outcome(jg.encode_text, text, vocab)
        if enc[0] == "ok":
            assert tg.decode_tokens(enc[1], vocab) == text
            assert t.accepts(enc[1]) == j.accepts(enc[1])
            eos = len(vocab) - 1
            with_eos = enc[1] + [eos]
            assert tg.decode_tokens(with_eos, vocab, eos_token=eos) == \
                jg.decode_tokens(with_eos, vocab, eos_token=eos)
            assert t.accepts(with_eos, eos_token=eos) == \
                j.accepts(with_eos, eos_token=eos)
    for eos in (None, len(vocab) - 1):
        _walk(j, t, seed, eos)


@pytest.mark.parametrize("vocab", ["own", "v2000"])
@pytest.mark.parametrize("pattern,own,texts", REGEXES,
                         ids=[r[0] for r in REGEXES])
def test_regex_token_fsm_matches_jax(pattern, own, texts, vocab):
    vocab = VOCABS[own if vocab == "own" else vocab]
    _check(_outcome(jg.token_fsm_from_regex, pattern, vocab),
           _outcome(tg.token_fsm_from_regex, pattern, vocab), vocab, texts,
           seed=len(pattern))


@pytest.mark.parametrize("vocab", ["v32", "v2000"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_json_schema_constraint_matches_jax(name, vocab):
    schema, vocab = SCHEMAS[name], VOCABS[vocab]
    assert tg.json_schema_to_regex(schema) == jg.json_schema_to_regex(schema)
    spec = {"schema": schema, "kind": "json_schema"}
    assert tg.constraint_key(spec) == jg.constraint_key(spec)
    _check(_outcome(jg.compile_constraint, spec, vocab),
           _outcome(tg.compile_constraint, spec, vocab), vocab,
           SCHEMA_TEXTS, seed=len(name))


@pytest.mark.parametrize("bad", [
    {"type": "null"}, {"type": "object", "properties": {}},
    {"type": "array"}, {"enum": []}, {"kind": "wat"}])
def test_malformed_specs_raise_as_jax(bad):
    """Unsupported schemas, and specs the compiler refuses, raise the
    same error in both packages; so does a regex spec with an empty
    pattern, one without a schema dict and a spec that is not a dict."""
    assert _outcome(tg.json_schema_to_regex, bad) == \
        _outcome(jg.json_schema_to_regex, bad)
    assert _outcome(tg.json_schema_to_regex, bad)[0] == "raise"
    for spec in ({"kind": "json_schema", "schema": bad}, bad,
                 {"kind": "regex", "pattern": ""}, {"kind": "json_schema"},
                 "not a dict"):
        got = _outcome(tg.compile_constraint, spec, VOCAB32)
        assert got == _outcome(jg.compile_constraint, spec, VOCAB32)
        assert got[0] == "raise"


def test_regex_error_is_a_value_error_in_both():
    assert issubclass(tg.RegexError, ValueError)
    with pytest.raises(tg.RegexError, match="tile"):
        tg.token_fsm_from_regex("[ab]x[ab]", list("abc"))
    assert tg.MAX_DFA_STATES == jg.MAX_DFA_STATES
    assert tg._METACHARS == jg._METACHARS
