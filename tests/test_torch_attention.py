"""The port's paged attention ops (`pddl_tpu_torch/ops/attention.py`)
against their JAX counterparts on the CPU.

- `paged_cache_insert` writes exactly what the JAX function writes — per
  row, multi-token chunk (the block-granular path), and with positions
  past the table deflected to the scratch block;
- the plain `paged_decode_attention` matches JAX's jnp path
  (`kernel=False`) and the Pallas kernel in interpret mode within 1e-5
  in f32: MHA and GQA, per-row depths including 0 and T*bs-1, a sliding
  window, and a multi-token chunk at an offset;
- on a CPU tensor the kernel wrapper runs its plain version and counts
  no launch, and the kernel module imports without a CUDA toolchain.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.ops.attention import paged_cache_insert as jax_insert
from pddl_tpu.ops.attention import paged_decode_attention as jax_attn
from pddl_tpu.ops.attention import paged_decode_attention_kernel as jax_kernel
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _random_paged(rng, b, hkv, bs, t, d):
    """A pool with disjoint per-row linear tables (the shape
    `tests/test_serve_paged.py` builds)."""
    n = 1 + b * t
    kp = rng.randn(n, hkv, bs, d).astype(np.float32)
    vp = rng.randn(n, hkv, bs, d).astype(np.float32)
    table = np.zeros((b, t), np.int32)
    for i in range(b):
        table[i] = 1 + i * t + np.arange(t)
    return kp, vp, table


def _both_insert(pool, kv, table, index):
    ref = np.asarray(jax_insert(jnp.asarray(pool), jnp.asarray(kv), table,
                                index))
    got = tatt.paged_cache_insert(torch.tensor(pool), torch.tensor(kv),
                                  torch.tensor(table),
                                  torch.as_tensor(index)
                                  if np.ndim(index) else int(index))
    return got.numpy(), ref


@pytest.mark.parametrize("hkv", [4, 2])
def test_paged_cache_insert_matches_jax(hkv):
    rng = np.random.RandomState(0)
    b, bs, t, d = 3, 4, 6, 8
    kp, _, table = _random_paged(rng, b, hkv, bs, t, d)
    # Per-row single-token write (the tick): no duplicate targets, so the
    # whole pool, scratch included, is equal.
    kv = rng.randn(b, hkv, 1, d).astype(np.float32)
    got, ref = _both_insert(kp, kv, table, np.array([5, 17, 0], np.int32))
    np.testing.assert_array_equal(got, ref)
    # Batch-1 chunk writes (block-granular read-modify-write): a
    # mid-block start, and one running off the table's end whose tail is
    # deflected to scratch. Scratch takes duplicate junk writes in an
    # unspecified order, so it is excluded; every real block is equal.
    kv2 = rng.randn(1, hkv, 10, d).astype(np.float32)
    for start in (9, t * bs - 3):
        got, ref = _both_insert(kp, kv2, table[:1], start)
        np.testing.assert_array_equal(got[1:], ref[1:])
    # Per-row multi-token write with one row running off its table.
    kv3 = rng.randn(b, hkv, 3, d).astype(np.float32)
    got, ref = _both_insert(kp, kv3, table, np.array([5, 22, 0], np.int32))
    np.testing.assert_array_equal(got[1:], ref[1:])


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_plain_decode_matches_jax_and_pallas_interpret(hq, hkv, window):
    """Single-token steps, per-row depths 0, mid-block and T*bs-1."""
    rng = np.random.RandomState(2)
    b, bs, t, d = 3, 4, 6, 8
    kp, vp, table = _random_paged(rng, b, hkv, bs, t, d)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    index = np.array([t * bs - 1, 0, 9], np.int32)
    ref = jax_attn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), table,
                   index, window=window, kernel=False)
    ref_k = jax_kernel(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       table, index, window=window, interpret=True)
    args = (torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
            torch.tensor(table), torch.tensor(index))
    got = tatt.paged_decode_attention(*args, window=window)
    got_plain = tatt.paged_decode_attention(*args, window=window,
                                            kernel=False)
    for g in (got, got_plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_k), **TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_plain_multi_token_chunk_matches_jax(window):
    """The chunk-prefill shape: batch 1, s > 1 at a scalar offset."""
    rng = np.random.RandomState(1)
    b, hkv, bs, t, d, s = 1, 2, 4, 6, 8, 5
    kp, vp, table = _random_paged(rng, b, hkv, bs, t, d)
    q = rng.randn(b, 4, s, d).astype(np.float32)
    ref = jax_attn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), table,
                   np.int32(7), window=window, kernel=False)
    got = tatt.paged_decode_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(table), 7, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_kernel_wrapper_on_cpu_runs_plain_and_counts_nothing():
    rng = np.random.RandomState(3)
    kp, vp, table = _random_paged(rng, 3, 2, 4, 6, 8)
    q = torch.tensor(rng.randn(3, 4, 1, 8).astype(np.float32))
    args = (q, torch.tensor(kp), torch.tensor(vp), torch.tensor(table),
            torch.tensor([5, 17, 0], dtype=torch.int32))
    before = dict(_kernels.launch_counts)
    got = tatt.paged_decode_attention_kernel(*args)
    assert _kernels.launch_counts == before
    torch.testing.assert_close(
        got, tatt.paged_decode_attention(*args, kernel=False),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="single-token"):
        tatt.paged_decode_attention(q.expand(3, 4, 2, 8).contiguous(),
                                    *args[1:], kernel=True)


def test_kernel_module_imports_without_a_cuda_toolchain():
    """Importing builds nothing: the compiler is never looked up or run
    until a kernel is first launched."""
    code = (
        "import shutil, subprocess\n"
        "def _no(*a, **k): raise AssertionError('toolchain touched')\n"
        "shutil.which = _no; subprocess.Popen = _no\n"
        "import pddl_tpu_torch.ops.attention\n"
        "from pddl_tpu_torch.ops import _kernels\n"
        "assert _kernels._libs == {}\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
