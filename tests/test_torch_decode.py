"""The port's row-cache decode ops against the JAX package's on the CPU.

- `decode_attention` with a scalar and a per-row `[B]` index, a window, a
  rolling ring (wrapped, and with never-written slots), `history_only`,
  `return_lse`, GQA and MHA, `scale`, a multi-token block whose last key
  chunk is shorter than `chunk`, and the `max_index` bound: f32 within
  rtol/atol 1e-5, bf16 caches within 2e-2;
- `_attention_reference_lse` (o and lse);
- the four cache copies `cache_slot_insert`, `cache_slot_reset`,
  `cache_blocks_gather` and `cache_blocks_scatter`, and the block-pool
  helpers `gather_prefix_into_row` and `donate_prefix_blocks`: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.attention as jatt
from pddl_tpu.serve.kvcache import block_pool as jpool
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.serve.kvcache import block_pool as tpool

TOL = {np.float32: 1e-5, "bfloat16": 2e-2}


def _inputs(seed, b, h, hkv, s, cache_len, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype(np.float32),
            rng.randn(b, hkv, cache_len, d).astype(np.float32),
            rng.randn(b, hkv, cache_len, d).astype(np.float32))


def _both(q, kc, vc, index, dtype=np.float32, **kw):
    """Run the JAX and the port function on the same numpy inputs; the
    cache is stored in ``dtype`` on both sides."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jidx = jnp.asarray(index, jnp.int32)
    ref = jatt.decode_attention(jnp.asarray(q), jnp.asarray(kc, jdt),
                                jnp.asarray(vc, jdt), jidx, **kw)
    tidx = (torch.tensor(index, dtype=torch.int32)
            if isinstance(index, (list, np.ndarray)) else index)
    got = tatt.decode_attention(torch.tensor(q), torch.tensor(kc).to(tdt),
                                torch.tensor(vc).to(tdt), tidx, **kw)
    return ref, got


def _close(ref, got, tol):
    """``o`` (and ``lse``) within ``tol``. Under ``return_lse``, rows that
    see no key (lse ``≈ NEG_INF`` on both sides) are held to that lse and
    to a zero, finite ``o`` on the port's side: the JAX function leaves
    junk there that a merge weighs by 0."""
    if isinstance(ref, tuple):
        o_ref, lse_ref = (np.asarray(x, np.float32) for x in ref)
        o, lse = (x.float().numpy() for x in got)
        empty = lse_ref < -1e29
        np.testing.assert_array_equal(lse < -1e29, empty)
        np.testing.assert_allclose(lse[~empty], lse_ref[~empty], rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(o[~empty], o_ref[~empty], rtol=tol,
                                   atol=tol)
        assert (o[empty] == 0).all()
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


# (name, b, h, hkv, s, cache_len, index, kw)
CASES = [
    ("scalar_step", 2, 4, 2, 1, 64, 37, {}),
    ("scalar_step_mha", 2, 4, 4, 1, 64, 63, {}),
    ("scalar_step_window", 2, 4, 2, 1, 64, 50, {"window": 9}),
    ("scalar_block", 1, 4, 2, 24, 96, 40, {"chunk": 32}),
    ("scalar_block_tail_chunk", 1, 4, 2, 17, 100, 33,
     {"chunk": 48, "window": 20}),
    ("scalar_scale", 2, 8, 2, 1, 64, 20, {"scale": 0.3}),
    ("row_index_step", 3, 4, 2, 1, 64, [0, 17, 63], {}),
    ("row_index_step_window", 3, 4, 2, 1, 64, [5, 30, 62], {"window": 7}),
    ("row_index_block", 3, 4, 2, 5, 64, [0, 17, 40], {"chunk": 16}),
    ("ring_step_unwrapped", 2, 4, 2, 1, 32, 10,
     {"window": 20, "rolling": True}),
    ("ring_step_wrapped", 2, 4, 2, 1, 32, 75,
     {"window": 20, "rolling": True}),
    ("ring_row_index", 3, 4, 2, 1, 32, [3, 31, 100],
     {"window": 32, "rolling": True}),
    ("ring_history", 1, 4, 2, 24, 32, 50,
     {"window": 20, "rolling": True, "history_only": True,
      "return_lse": True, "chunk": 12}),
    ("ring_history_short", 1, 4, 2, 24, 32, 7,
     {"window": 20, "rolling": True, "history_only": True,
      "return_lse": True, "chunk": 12}),
    ("history_empty", 2, 4, 2, 8, 32, 0,
     {"window": 20, "rolling": True, "history_only": True,
      "return_lse": True}),
    ("history_row_index", 3, 4, 2, 1, 48, [0, 9, 30],
     {"history_only": True, "return_lse": True}),
    ("lse_block", 1, 4, 2, 12, 64, 20, {"return_lse": True, "chunk": 7}),
]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,b,h,hkv,s,cache_len,index,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_attention_matches_jax(name, b, h, hkv, s, cache_len, index,
                                      kw, dtype):
    seed = [c[0] for c in CASES].index(name)
    q, kc, vc = _inputs(seed, b, h, hkv, s, cache_len)
    ref, got = _both(q, kc, vc, index, dtype, **kw)
    _close(ref, got, TOL[dtype])


@pytest.mark.parametrize("rolling", [False, True])
def test_decode_attention_max_index_bounds_the_sweep(rolling):
    """A per-row index with its host bound reads only the live prefix and
    gives what a whole-cache sweep gives; the same with junk (NaN) past
    the prefix shows nothing past it is read."""
    index = [4, 21, 9]
    q, kc, vc = _inputs(3, 3, 4, 2, 1, 64)
    kw = {"window": 40, "rolling": True} if rolling else {}
    idx = torch.tensor(index, dtype=torch.int32)
    whole = tatt.decode_attention(torch.tensor(q), torch.tensor(kc),
                                  torch.tensor(vc), idx, **kw)
    kt, vt = torch.tensor(kc), torch.tensor(vc)
    kt[:, :, 22:] = float("nan")
    vt[:, :, 22:] = float("nan")
    bounded = tatt.decode_attention(torch.tensor(q), kt, vt, idx,
                                    max_index=21, **kw)
    torch.testing.assert_close(bounded, whole, rtol=1e-6, atol=1e-6)
    ref, _ = _both(q, kc, vc, index, **kw)
    _close(ref, bounded, 1e-5)


def test_decode_attention_rolling_validates_statics():
    q = torch.zeros(1, 2, 1, 8)
    c = torch.zeros(1, 2, 64, 8)
    with pytest.raises(ValueError, match="sliding window"):
        tatt.decode_attention(q, c, c, 0, rolling=True)
    with pytest.raises(ValueError, match="overwritten"):
        tatt.decode_attention(q, c, c, 0, rolling=True, window=100)
    with pytest.raises(ValueError, match=r"\[B\]"):
        tatt.decode_attention(q, c, c, torch.tensor([1, 2]))


@pytest.mark.parametrize("window,k_offset", [(None, 0), (5, 0), (None, -4)])
def test_attention_reference_lse_matches_jax(window, k_offset):
    q, k, v = _inputs(8, 2, 4, 2, 12, 12)
    ref = jatt._attention_reference_lse(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), True, 0.25, window,
                                        k_offset)
    got = tatt._attention_reference_lse(torch.tensor(q), torch.tensor(k),
                                        torch.tensor(v), True, 0.25, window,
                                        k_offset)
    _close(ref, got, 1e-5)


def _pool_and_row(seed=0, n=6, hkv=2, bs=4, d=8, row_len=20):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, hkv, bs, d).astype(np.float32),
            rng.randn(1, hkv, row_len, d).astype(np.float32))


def test_cache_slot_insert_and_reset_match_jax():
    rng = np.random.RandomState(1)
    pool = rng.randn(3, 2, 10, 4).astype(np.float32)
    row = rng.randn(1, 2, 10, 4).astype(np.float32)
    ref = jatt.cache_slot_insert(jnp.asarray(pool), jnp.asarray(row), 2)
    got = tatt.cache_slot_insert(torch.tensor(pool), torch.tensor(row), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jatt.cache_slot_reset(ref, 1)
    got = tatt.cache_slot_reset(got, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="batch-1"):
        tatt.cache_slot_insert(got, got[:2], 0)


@pytest.mark.parametrize("ids", [[3, 1, 5], [2], []])
def test_cache_blocks_gather_matches_jax(ids):
    pool, _ = _pool_and_row()
    ref = jatt.cache_blocks_gather(jnp.asarray(pool),
                                   jnp.asarray(ids, jnp.int32))
    got = tatt.cache_blocks_gather(torch.tensor(pool), ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ids,start", [([3, 1], 0), ([4, 2, 5], 2),
                                       ([1, 2], 4)])
def test_cache_blocks_scatter_matches_jax(ids, start):
    """Unique ids (the scatter of a repeated id has no order in either
    package); the last case reads past the row's end (clamped)."""
    pool, row = _pool_and_row()
    ref = jatt.cache_blocks_scatter(jnp.asarray(pool), jnp.asarray(row),
                                    jnp.asarray(ids, jnp.int32), start)
    got = tatt.cache_blocks_scatter(torch.tensor(pool), torch.tensor(row),
                                    ids, start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="outside"):
        tatt.cache_blocks_scatter(got, torch.tensor(row), [6], 0)


def _trees(pool, row, depth=2):
    """A JAX pool/row tree pair and the port's, with per-layer copies."""
    jp = {f"block{i}": {"attn": {
        "cached_key": jnp.asarray(pool + i),
        "cached_value": jnp.asarray(-pool),
        "cache_index": jnp.zeros((), jnp.int32)}} for i in range(depth)}
    jr = {f"block{i}": {"attn": {
        "cached_key": jnp.asarray(row + i), "cached_value": jnp.asarray(-row),
        "cache_index": jnp.int32(7)}} for i in range(depth)}
    tp = {f"block{i}": {"attn": {
        "cached_key": torch.tensor(pool + i),
        "cached_value": torch.tensor(-pool)}} for i in range(depth)}
    tr = {f"block{i}": {"attn": {
        "cached_key": torch.tensor(row + i),
        "cached_value": torch.tensor(-row)}} for i in range(depth)}
    return jp, jr, tp, tr


def _assert_tree_equal(tree, jtree):
    for blk, leaves in tree.items():
        for name, leaf in leaves["attn"].items():
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(jtree[blk]["attn"][name]),
                err_msg=f"{blk}.{name}")


def test_gather_prefix_into_row_matches_jax():
    pool, row = _pool_and_row(2)
    jp, jr, tp, tr = _trees(pool, row)
    ids = [4, 2, 5]
    ref = jpool.gather_prefix_into_row(jp, jr, jnp.asarray(ids, jnp.int32))
    got = tpool.gather_prefix_into_row(tp, tr, ids)
    assert got is tr  # written in place
    _assert_tree_equal(got, ref)


def test_donate_prefix_blocks_matches_jax():
    pool, row = _pool_and_row(3)
    jp, jr, tp, tr = _trees(pool, row)
    ids = [5, 1]
    ref = jpool.donate_prefix_blocks(jp, jr, jnp.asarray(ids, jnp.int32), 1)
    got = tpool.donate_prefix_blocks(tp, tr, ids, 1)
    assert got is tp
    _assert_tree_equal(got, ref)
