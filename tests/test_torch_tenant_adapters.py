"""The port's adapter machinery (`pddl_tpu_torch/serve/tenant/adapters.py`,
`pddl_tpu_torch/ops/lora.py`) against the JAX package's, on the CPU.

- `AdapterRegistry`: the same shape and rank errors (type and message),
  the same rank zero-padding and pre-folded scale (bitwise), and
  `register_random` factors bitwise equal to the JAX registry's for the
  same seeds and ranks.
- `AdapterPool`: one op trace (assign into free rows, pin, LRU eviction
  under a full pool with pins protecting rows, lookup refreshing the LRU
  order, exhaustion, unpin underflow, unassign) gives the same rows,
  victims, eviction counts, residency and errors.
- `batched_lora_delta` within 1e-6 (f32, absolute and relative) of the
  JAX op on seeded pools, mixed rows with the identity row exactly 0.0;
  the verify's window form `[B, W, d]` equals the flat form over the
  repeated rows within the same tolerance; `adapter_pool_load` writes
  the row the JAX op writes.
- `merge_lora_into_head` against the JAX `merge_lora_into_head` through
  the weight bridge: the merged head weight within 1e-6 and the merged
  model's logits within 1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.lora as jlora
import pddl_tpu.serve.tenant.adapters as jad
import pddl_tpu_torch.ops.lora as tlora
import pddl_tpu_torch.serve.tenant.adapters as tad
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.models.llama import tiny_llama

D, V, RANK = 32, 40, 4


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, KeyError, RuntimeError) as e:
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("a_shape,b_shape", [
    ((7, 2), (2, V)), ((D, 2), (3, V)), ((D, 2), (2, V + 1)),
    ((D, 8), (8, V)), ((D,), (2, V))])
def test_registry_validation_matches_jax(a_shape, b_shape):
    regs = [m.AdapterRegistry(D, V, rank=RANK) for m in (jad, tad)]
    got = [_outcome(r.register, "bad", np.zeros(a_shape), np.zeros(b_shape))
           for r in regs]
    assert got[0] == got[1] and got[0][0] == "raise"
    assert [_outcome(m.AdapterRegistry, D, V, rank=0)[:2]
            for m in (jad, tad)] == [("raise", "ValueError")] * 2
    assert [_outcome(r.get, "nobody") for r in regs][0] == \
        _outcome(regs[1].get, "nobody")


@pytest.mark.parametrize("rank", [1, 2, RANK])
def test_padding_and_register_random_bitwise(rank):
    rng = np.random.RandomState(rank)
    a = rng.randn(D, rank).astype(np.float32)
    b = rng.randn(rank, V).astype(np.float32)
    regs = [m.AdapterRegistry(D, V, rank=RANK) for m in (jad, tad)]
    ja, ta = (r.register("small", a, b, scale=0.5) for r in regs)
    assert type(ta).__module__ == tad.__name__
    np.testing.assert_array_equal(ta.a, ja.a)
    np.testing.assert_array_equal(ta.b, ja.b)
    assert ta.a.shape == (D, RANK) and ta.b.shape == (RANK, V)
    assert ta.nbytes == ja.nbytes
    for i, name in enumerate(["acme", "globex", "initech"]):
        jr, tr = (r.register_random(name, seed=100 + i, scale=0.1,
                                    rank=rank) for r in regs)
        np.testing.assert_array_equal(tr.a, jr.a)
        np.testing.assert_array_equal(tr.b, jr.b)
    assert regs[1].names == regs[0].names
    assert len(regs[1]) == len(regs[0]) and "acme" in regs[1]
    assert regs[1].adapter_nbytes == regs[0].adapter_nbytes


# (op, argument): "assign"/"lookup"/"unassign" take a name or row,
# "pin"/"unpin" the row an earlier assign of that name returned.
TRACE = [("assign", "a1"), ("assign", "a2"), ("assign", "a3"),
         ("pin", "a1"), ("lookup", "a2"), ("assign", "a4"),
         ("lookup", "a3"), ("pin", "a4"), ("assign", "a5"),
         ("pin", "a5"), ("assign", "a6"), ("unpin", "a4"),
         ("assign", "a6"), ("assign", "a6"), ("unpin", "a1"),
         ("unpin", "a1"), ("pin", 0), ("unpin", 0), ("unassign", "a6"),
         ("assign", "a7"), ("lookup", "a1"), ("assign", "a8")]


@pytest.mark.parametrize("slots", [1, 4, 5])
def test_adapter_pool_trace_matches_jax(slots):
    """The pool's decisions are integer bookkeeping: every return value,
    victim, error and counter is equal."""
    made = [_outcome(m.AdapterPool, slots) for m in (jad, tad)]
    assert [x[0] for x in made] == [made[0][0]] * 2
    if made[0][0] == "raise":
        assert made[0] == made[1]
        return
    pools = [x[1] for x in made]
    rows = [{}, {}]
    for op, arg in TRACE:
        out = []
        for pool, seen in zip(pools, rows):
            if op in ("pin", "unpin"):
                r = _outcome(getattr(pool, op), seen.get(arg, arg))
            elif op == "unassign":
                r = _outcome(pool.unassign, seen.get(arg, -1)) \
                    if arg in seen else ("skip",)
            else:
                r = _outcome(getattr(pool, op), arg)
                if op == "assign" and r[0] == "ok":
                    seen[arg] = r[1]
            out.append((r[:2] if r[0] == "raise" else r, pool.resident,
                        pool.evictions, pool.pinned_rows(),
                        {n: pool.row_of(n) for n in seen}))
        assert out[0] == out[1], (op, arg)
    assert issubclass(tad.AdapterPoolExhausted, RuntimeError)
    if slots < 5:  # the trace fills a small pool: it evicted and refused
        assert pools[1].evictions > 0


def _pools(seed, p, d, r, v):
    rng = np.random.RandomState(seed)
    pa = rng.randn(p, d, r).astype(np.float32)
    pb = (0.1 * rng.randn(p, r, v)).astype(np.float32)
    pa[0] = 0.0
    pb[0] = 0.0
    return pa, pb


@pytest.mark.parametrize("feat_dtype", [np.float32, "bfloat16"])
def test_batched_lora_delta_matches_jax(feat_dtype):
    pa, pb = _pools(0, 5, D, RANK, V)
    rng = np.random.RandomState(1)
    feats = rng.randn(6, D).astype(np.float32)
    rows = np.array([0, 3, 1, 0, 4, 3], np.int32)
    if feat_dtype == "bfloat16":
        jf = jnp.asarray(feats, jnp.bfloat16)
        tf = torch.from_numpy(feats).to(torch.bfloat16)
    else:
        jf, tf = jnp.asarray(feats), torch.from_numpy(feats)
    want = np.asarray(jlora.batched_lora_delta(jf, jnp.asarray(pa),
                                               jnp.asarray(pb),
                                               jnp.asarray(rows)))
    got = tlora.batched_lora_delta(tf, torch.from_numpy(pa),
                                   torch.from_numpy(pb),
                                   torch.from_numpy(rows))
    assert got.dtype == torch.float32 and got.shape == (6, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # The identity row adds an exact zero.
    assert not got[rows == 0].any()
    # The verify's window form: every position of a row on its adapter.
    win = rng.randn(6, 3, D).astype(np.float32)
    flat = jlora.batched_lora_delta(jnp.asarray(win.reshape(18, D)),
                                    jnp.asarray(pa), jnp.asarray(pb),
                                    jnp.repeat(jnp.asarray(rows), 3))
    got_w = tlora.batched_lora_delta(torch.from_numpy(win),
                                     torch.from_numpy(pa),
                                     torch.from_numpy(pb),
                                     torch.from_numpy(rows))
    assert got_w.shape == (6, 3, V)
    np.testing.assert_allclose(got_w.numpy(),
                               np.asarray(flat).reshape(6, 3, V),
                               rtol=1e-6, atol=1e-6)


def test_adapter_pool_load_matches_jax():
    pa, pb = _pools(2, 4, D, RANK, V)
    rng = np.random.RandomState(3)
    a = rng.randn(D, RANK).astype(np.float32)
    b = rng.randn(RANK, V).astype(np.float32)
    ja, jb = jlora.adapter_pool_load(jnp.asarray(pa), jnp.asarray(pb), 2,
                                     a, b)
    ta, tb = torch.from_numpy(pa.copy()), torch.from_numpy(pb.copy())
    assert tlora.adapter_pool_load(ta, tb, 2, a, b) is None  # in place
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tlora.IDENTITY_ROW == jlora.IDENTITY_ROW == 0


@pytest.mark.parametrize("vocab_multiple", [1, 16])
def test_merge_lora_into_head_matches_jax(vocab_multiple):
    """The oracle on both sides: the JAX merge of the flax tree bridged
    into a port model against the port's merge of the bridged model
    (the head weight is the kernel's transpose, padded rows untouched)."""
    jm = jax_tiny_llama(vocab_size=V, max_len=32, embed_dim=D,
                        vocab_multiple=vocab_multiple)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    reg = jad.AdapterRegistry(D, V, rank=RANK)
    ad = reg.register_random("acme", seed=7, scale=0.1)
    tm = tiny_llama(vocab_size=V, max_len=32, embed_dim=D,
                    vocab_multiple=vocab_multiple, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    merged = tlora.merge_lora_into_head(tm, ad.a, ad.b)
    want = llama_params_from_jax(jax.tree.map(
        np.asarray, jlora.merge_lora_into_head(params, ad.a, ad.b)))
    got = merged.state_dict()
    for key, val in want.items():
        tol = 1e-6 if key == "head.lm_head.weight" else 0
        torch.testing.assert_close(got[key], val, rtol=tol, atol=tol)
    # The original model is untouched, and the merged head is adapted.
    assert torch.equal(tm.state_dict()["head.lm_head.weight"],
                       llama_params_from_jax(jax.tree.map(
                           np.asarray, params))["head.lm_head.weight"])
    tokens = np.arange(10)[None] % V
    jlog = jm.apply({"params": jlora.merge_lora_into_head(params, ad.a,
                                                          ad.b)},
                    jnp.asarray(tokens), train=False)
    with torch.no_grad():
        tlog = merged(torch.from_numpy(tokens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
