"""The port's flash attention (`pddl_tpu_torch/ops/attention.py`) against
the JAX package's on the CPU.

The JAX side runs its Pallas kernels in interpret mode with 32-row blocks
(as `tests/test_attention.py` does); the port's entry points run their
kernels' plain versions, the only thing they run on a CPU tensor. Inputs
are drawn with numpy from a seed and handed to both.

Tolerances, f32 throughout: outputs and LSE within 1e-5 (the two sum the
same terms in another order: blockwise online softmax there, one softmax
here); gradients within 3e-4, because the backward recomputes p from the
saved LSE and sums over up to 128 keys and a query group, so the order
differences of the forward grow by the scores' magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.attention as jatt
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=3e-4, atol=3e-4)
BLOCKS = dict(block_q=32, block_k=32)


def _inputs(seed, b=1, h=4, hkv=2, sq=128, sk=None, d=16):
    rng = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, sk, d).astype(np.float32)
    v = rng.randn(b, hkv, sk, d).astype(np.float32)
    g = rng.randn(b, h, sq, d).astype(np.float32)
    glse = rng.randn(b, h, sq).astype(np.float32)
    return q, k, v, g, glse


def _jax_grads(fn, q, k, v):
    return jax.grad(fn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))


def _torch_grads(fn, q, k, v):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    fn(*leaves).backward()
    return [x.grad for x in leaves]


def _close(got, want, tol, what):
    for a, b, name in zip(got, want, what):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_forward_matches_jax(hkv, window):
    """GQA rep 1, 2 and 4, causal with and without a window, and the LSE
    entry point's (o, lse) pair."""
    q, k, v, _, _ = _inputs(0, hkv=hkv)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    ref = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window,
                               **BLOCKS)
    before = dict(_kernels.launch_counts)
    got = tatt.flash_attention(tq, tk, tv, causal=True, window=window,
                               **BLOCKS)
    assert _kernels.launch_counts == before  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    ref_o, ref_lse = jatt.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, **BLOCKS)
    o, lse = tatt.flash_attention_lse(tq, tk, tv, causal=True,
                                      window=window, **BLOCKS)
    _close((o.numpy(), lse.numpy()), (ref_o, ref_lse), FWD, ("o", "lse"))


def test_noncausal_odd_scale_forward_matches_jax():
    """No mask, and a scale that is not a power of two (stays in-kernel
    rather than folded into q), with Sq != Sk."""
    q, k, v, _, _ = _inputs(1, sq=64, sk=96)
    ref = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale=0.3, **BLOCKS)
    got = tatt.flash_attention(*map(torch.tensor, (q, k, v)), scale=0.3,
                               **BLOCKS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("two_sweep", [False, True])
@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_gradients_match_jax(monkeypatch, hkv, window, two_sweep):
    """dq, dk, dv through the fused branch (K2) and through the two-sweep
    branch (K3a/K3b), forced on both sides with a zero dq budget."""
    if two_sweep:
        monkeypatch.setattr(jatt, "_FUSED_BWD_DQ_BYTES", 0)
        monkeypatch.setattr(tatt, "_FUSED_BWD_DQ_BYTES", 0)
    q, k, v, g, _ = _inputs(2, hkv=hkv)
    want = _jax_grads(lambda a, b, c: jnp.sum(jatt.flash_attention(
        a, b, c, causal=True, window=window, **BLOCKS) * g), q, k, v)
    tg = torch.tensor(g)
    got = _torch_grads(lambda a, b, c: (tatt.flash_attention(
        a, b, c, causal=True, window=window, **BLOCKS) * tg).sum(), q, k, v)
    _close(got, want, GRAD, ("dq", "dk", "dv"))


@pytest.mark.parametrize("k_offset,window", [(-64, None), (-32, 48)])
def test_lse_with_k_offset_and_dlse_matches_jax(k_offset, window):
    """Ring attention's shape: keys ``-k_offset`` positions earlier than
    their index, with a cotangent on the LSE output as well as on o."""
    q, k, v, g, glse = _inputs(3, hkv=2)
    kw = dict(causal=True, window=window, k_offset=k_offset, **BLOCKS)

    def jloss(a, b, c):
        o, lse = jatt.flash_attention_lse(a, b, c, **kw)
        return jnp.sum(o * g) + jnp.sum(lse * glse)

    jo, jl = jatt.flash_attention_lse(*map(jnp.asarray, (q, k, v)), **kw)
    to, tl = tatt.flash_attention_lse(*map(torch.tensor, (q, k, v)), **kw)
    _close((to.numpy(), tl.numpy()), (jo, jl), FWD, ("o", "lse"))
    tg, tgl = torch.tensor(g), torch.tensor(glse)

    def tloss(a, b, c):
        o, lse = tatt.flash_attention_lse(a, b, c, **kw)
        return (o * tg).sum() + (lse * tgl).sum()

    _close(_torch_grads(tloss, q, k, v), _jax_grads(jloss, q, k, v), GRAD,
           ("dq", "dk", "dv"))


def test_degenerate_tiling_takes_the_reference_on_both_sides():
    """A prime length whose largest dividing block under 8 is 1: the JAX
    package falls back to its reference there. The port's kernels tile by
    64 and mask ragged edges, so the port keeps its flash path (its
    autograd Function, the kernels' plain versions on the CPU); both
    agree with the reference, forward and gradients."""
    q, k, v, g, _ = _inputs(4, sq=13)
    small = dict(block_q=8, block_k=8)
    ref = jatt.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               **small)
    got = tatt.flash_attention(*map(torch.tensor, (q, k, v)), causal=True,
                               **small)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    plain = tatt.attention_reference(*map(torch.tensor, (q, k, v)),
                                     causal=True)
    torch.testing.assert_close(got, plain, **FWD)
    want = _jax_grads(lambda a, b, c: jnp.sum(jatt.flash_attention(
        a, b, c, causal=True, **small) * g), q, k, v)
    tg = torch.tensor(g)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tatt.flash_attention(*leaves, causal=True, **small)
    assert type(o.grad_fn).__name__ == "_FlashBackward"
    (o * tg).sum().backward()
    _close([x.grad for x in leaves], want, GRAD, ("dq", "dk", "dv"))


def test_plain_backward_equals_autograd_of_the_plain_forward():
    """The written-out backward is the gradient of the kernel's plain
    forward (the check `chip_smoke.py` relies on when it holds K2 against
    it)."""
    q, k, v, g, glse = _inputs(5, hkv=1, sq=40, d=8)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    kw = dict(causal=True, scale=0.25, window=9, k_offset=-3)
    o, lse = tatt.flash_forward_plain(tq, tk, tv, **kw)
    do, dlse = torch.tensor(g), torch.tensor(glse)
    ((o * do).sum() + (lse * dlse).sum()).backward()
    dq, dk, dv = tatt.flash_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), o.detach(), lse.detach(), do,
        dlse, **kw)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
